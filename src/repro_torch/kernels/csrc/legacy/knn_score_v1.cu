// The first CUDA design of knn_score (sequential, before the shared tile
// mainloop of ../score_tile.cuh), kept only to show that the present
// ../knn_score.cu gives bit for bit its outputs: chip_smoke.py builds it
// and compares once at the engine's shapes.  On no path of the port.
//
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
// the result is unchanged.
//
// Where the TPU design does not carry over: the Pallas (block_r, block_s)
// f32 accumulator is 256 KB at the defaults, beyond a CTA's 227 KB, and one
// CTA per block pair would leave most of the 132 SMs empty.  So a CTA owns a
// 64 x 64 sub-tile of one pair (never crossing a pair's edge, so one active
// list serves it): 256 threads, a 4 x 4 register micro-tile each (rows
// ty + 16 i, columns tx + 16 j).  It reads the pair's active list itself,
// stages 32-dim slices of the R and S tiles in shared memory (row pitch 33:
// no bank conflicts) and accumulates in fp32 FMA (no TF32), then writes its
// outputs once.  At the engine's shapes (NR = 2048, NS = 10,240, blocks of
// 256) that is 5,120 CTAs.
//
// Sums are taken tile by tile in list (ascending) order and dim by dim
// within a tile, sequentially per output.  The plain version
// (knn_score/ref.py) sums each tile product in cuBLAS's order and then
// over tiles, so the two agree within rtol=1e-5, atol=1e-6, not bit for
// bit.
//
// Bound: operations.  2 * 256 * 256 * 128 flop for every active (R block,
// S block, tile) triple; 25,280 triples at the engine's shapes give
// 4.24e11 flop, 6.33 ms at the H100 SXM's 67 TFLOP/s fp32.  Bytes (the
// tile stacks read once, the scores written once) are ~0.59 GB, 0.18 ms.
// A 4 x 4 micro-tile a thread and no pipeline: ~21.8 ms on an H100.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;     // a 16 x 16 thread grid
constexpr int kSub = 64;          // rows and columns of a CTA's sub-tile
constexpr int kMicro = kSub / 16;  // a thread's 4 x 4 micro-tile
constexpr int kDepth = 32;        // dims staged per shared-memory step
constexpr int kPad = kDepth + 1;  // row pitch of the staged slices

struct Params {
  const float* r_tiles;  // (T+1, NR, tile)
  const float* s_tiles;  // (T+1, NS, tile)
  const int* active;     // (nR, nS, A)
  float* out;            // (NR, NS)
  int t1, n_r, n_s, tile, n_sb, a_len, block_r, block_s, sub_r, sub_s;
};

__global__ void __launch_bounds__(kThreads) knn_score_kernel(Params p) {
  __shared__ float rs[kSub * kPad];
  __shared__ float ss[kSub * kPad];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ctas_s = p.n_sb * p.sub_s;
  const int cta_r = blockIdx.x / ctas_s, cta_s = blockIdx.x % ctas_s;
  const int bi = cta_r / p.sub_r, bj = cta_s / p.sub_s;
  const int r_lo = (cta_r % p.sub_r) * kSub, c_lo = (cta_s % p.sub_s) * kSub;
  const int nrow = min(kSub, p.block_r - r_lo);
  const int ncol = min(kSub, p.block_s - c_lo);
  const int row0 = bi * p.block_r + r_lo;
  const int col0 = bj * p.block_s + c_lo;
  const unsigned sentinel = (unsigned)(p.t1 - 1);
  const int* act = p.active + ((size_t)bi * p.n_sb + bj) * p.a_len;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int a = 0; a < p.a_len; ++a) {
    const int t = act[a];
    if ((unsigned)t >= sentinel) break;
    const float* rt = p.r_tiles + ((size_t)t * p.n_r + row0) * p.tile;
    const float* st = p.s_tiles + ((size_t)t * p.n_s + col0) * p.tile;
    for (int d0 = 0; d0 < p.tile; d0 += kDepth) {
      for (int e = tid; e < kSub * kDepth; e += kThreads) {
        const int r = e / kDepth, d = e % kDepth;
        const bool in = d0 + d < p.tile;
        rs[r * kPad + d] = (r < nrow && in) ? rt[(size_t)r * p.tile + d0 + d] : 0.f;
        ss[r * kPad + d] = (r < ncol && in) ? st[(size_t)r * p.tile + d0 + d] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDepth; ++d) {
        float b[kMicro];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) b[j] = ss[(tx + 16 * j) * kPad + d];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          const float av = rs[(ty + 16 * i) * kPad + d];
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = tx + 16 * j;
      if (r < nrow && c < ncol) p.out[(size_t)(row0 + r) * p.n_s + col0 + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int knn_score_v1_launch(const float* r_tiles, const float* s_tiles, const int* active,
                                float* out, int t1, int n_r, int n_s, int tile, int n_rb,
                                int n_sb, int a_len, int block_r, int block_s, void* stream) {
  if (t1 < 1 || tile < 1 || n_rb < 1 || n_sb < 1 || a_len < 0 || block_r < 1 || block_s < 1 ||
      n_r != n_rb * block_r || n_s != n_sb * block_s)
    return (int)cudaErrorInvalidValue;
  const int sub_r = (block_r + kSub - 1) / kSub, sub_s = (block_s + kSub - 1) / kSub;
  const long long ctas = (long long)n_rb * sub_r * n_sb * sub_s;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Params p{r_tiles, s_tiles, active, out, t1, n_r, n_s, tile, n_sb, a_len,
                 block_r, block_s, sub_r, sub_s};
  knn_score_kernel<<<(unsigned)ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* knn_score_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
