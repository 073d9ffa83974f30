// The first design of the WKV kernel (RWKV6 time mixing): one CTA of 256
// threads per (b h) walks its chunks in order with the (K, K) state in
// shared memory; ~212 KB of shared memory at C 128, K 64, so one CTA an
// SM.  On no path of the port: chip_smoke.py and the card tests hold the
// chunk-parallel kernels of ../wkv.cu to its outputs bit for bit and time
// them beside it, on the same inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "../bf16_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kClamp = 30.f;

template <int C, int K>
struct Shape {
  static constexpr int LDK = K + 1;   // odd strides: 16 rows of one column
  static constexpr int LDC = C + 1;   // fall in 16 different banks
  static constexpr int MA = C / 16;   // token rows a thread
  static constexpr int NB = K / 16;   // channel columns a thread
  static constexpr int kFloats = 4 * C * LDK + C * LDC + K * LDK + C + 2 * K;
  static constexpr size_t kSmem = sizeof(float) * (size_t)kFloats;
};

// One (C, K) tile of a (T, K) sequence into shared memory (row stride
// LDK), as f32; tokens at or past t read as zeros.
template <int C, int K, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int t0, int t) {
  using S = Shape<C, K>;
  for (int idx = threadIdx.x; idx < C * K / 4; idx += kThreads) {
    const int i = idx / (K / 4), c = (idx % (K / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + i < t) x = load4(src + (size_t)(t0 + i) * K + c);
    float* d = dst + i * S::LDK + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

template <int C, int K, typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ lw, const float* __restrict__ u, T* __restrict__ out, int t) {
  using S = Shape<C, K>;
  extern __shared__ float smem[];
  float* rs = smem;                 // r, then ri
  float* ks = rs + C * S::LDK;      // k, then kj
  float* vs = ks + C * S::LDK;      // v
  float* ls = vs + C * S::LDK;      // lw, then k_carry
  float* sc = ls + C * S::LDK;      // masked scores (C, C)
  float* st = sc + C * S::LDC;      // state (K, K)
  float* dg = st + K * S::LDK;      // sum(r k u) per token
  float* lt = dg + C;               // ltot per channel
  float* us = lt + K;               // u

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)bh * t * K;
  for (int i = tid; i < K * S::LDK; i += kThreads) st[i] = 0.f;
  for (int c = tid; c < K; c += kThreads) us[c] = u[(size_t)bh * K + c];

  for (int t0 = 0; t0 < t; t0 += C) {
    __syncthreads();  // the previous chunk is done with every buffer
    stage<C, K>(rs, r + base, t0, t);
    stage<C, K>(ks, k + base, t0, t);
    stage<C, K>(vs, v + base, t0, t);
    stage<C, K>(ls, lw + base, t0, t);
    __syncthreads();

    // the u diagonal from the raw r and k; ltot per channel
    for (int i = tid; i < C; i += kThreads) {
      float d = 0.f;
      for (int c = 0; c < K; ++c) d += rs[i * S::LDK + c] * (ks[i * S::LDK + c] * us[c]);
      dg[i] = d;
    }
    if (tid < K) {
      float acc = 0.f;
      for (int i = 0; i < C; ++i) acc += ls[i * S::LDK + tid];
      lt[tid] = acc;
    }
    __syncthreads();

    // in place: r -> ri, k -> kj, lw -> k_carry; the same sequential sum as ltot
    if (tid < K) {
      const int c = tid;
      const float ltot = lt[c];
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        const float lwv = ls[i * S::LDK + c];
        acc += lwv;
        const float kv = ks[i * S::LDK + c];
        rs[i * S::LDK + c] *= expf(acc - lwv);
        ks[i * S::LDK + c] = kv * expf(fminf(fmaxf(-acc, -kClamp), kClamp));
        ls[i * S::LDK + c] = kv * expf(fminf(ltot - acc, kClamp));
      }
    }
    __syncthreads();

    // scores (rows ty + 16a, cols tx + 16b, b <= a) and inter = ri S
    {
      float s[S::MA][S::MA];
#pragma unroll
      for (int a = 0; a < S::MA; ++a)
#pragma unroll
        for (int b = 0; b < S::MA; ++b) s[a][b] = 0.f;
#pragma unroll 2
      for (int c = 0; c < K; ++c) {
        float ra[S::MA], kb[S::MA];
#pragma unroll
        for (int a = 0; a < S::MA; ++a) ra[a] = rs[(ty + 16 * a) * S::LDK + c];
#pragma unroll
        for (int b = 0; b < S::MA; ++b) kb[b] = ks[(tx + 16 * b) * S::LDK + c];
#pragma unroll
        for (int a = 0; a < S::MA; ++a)
#pragma unroll
          for (int b = 0; b <= a; ++b) s[a][b] = fmaf(ra[a], kb[b], s[a][b]);
      }
#pragma unroll
      for (int a = 0; a < S::MA; ++a)
#pragma unroll
        for (int b = 0; b < S::MA; ++b) {
          const bool keep = b < a || (b == a && tx < ty);
          sc[(ty + 16 * a) * S::LDC + tx + 16 * b] = keep ? s[a][b] : 0.f;
        }
    }
    float inter[S::MA][S::NB];
#pragma unroll
    for (int a = 0; a < S::MA; ++a)
#pragma unroll
      for (int b = 0; b < S::NB; ++b) inter[a][b] = 0.f;
#pragma unroll 2
    for (int c = 0; c < K; ++c) {
      float sb[S::NB];
#pragma unroll
      for (int b = 0; b < S::NB; ++b) sb[b] = st[c * S::LDK + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < S::MA; ++a) {
        const float ra = rs[(ty + 16 * a) * S::LDK + c];
#pragma unroll
        for (int b = 0; b < S::NB; ++b) inter[a][b] = fmaf(ra, sb[b], inter[a][b]);
      }
    }
    __syncthreads();

    // intra = scores v over the causal triangle, plus the u diagonal
    float intra[S::MA][S::NB];
#pragma unroll
    for (int a = 0; a < S::MA; ++a)
#pragma unroll
      for (int b = 0; b < S::NB; ++b) intra[a][b] = 0.f;
    for (int jb = 0; jb < S::MA; ++jb) {
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * jb + jj;
        float vb[S::NB];
#pragma unroll
        for (int b = 0; b < S::NB; ++b) vb[b] = vs[j * S::LDK + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < S::MA; ++a) {
          if (a < jb) continue;  // rows of block a see no column of a later block
          const float sa = sc[(ty + 16 * a) * S::LDC + j];
#pragma unroll
          for (int b = 0; b < S::NB; ++b) intra[a][b] = fmaf(sa, vb[b], intra[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < S::MA; ++a) {
      const int i = ty + 16 * a;
      if (t0 + i >= t) continue;
      const float d = dg[i];
#pragma unroll
      for (int b = 0; b < S::NB; ++b) {
        const int c = tx + 16 * b;
        const float o = (intra[a][b] + d * vs[i * S::LDK + c]) + inter[a][b];
        store1(out + base + (size_t)(t0 + i) * K + c, o);
      }
    }

    // S = S diag(e^{ltot}) + k_carry^T v: rows ty + 16a, cols tx + 16b
    {
      float upd[S::NB][S::NB];
#pragma unroll
      for (int a = 0; a < S::NB; ++a)
#pragma unroll
        for (int b = 0; b < S::NB; ++b) upd[a][b] = 0.f;
#pragma unroll 2
      for (int i = 0; i < C; ++i) {
        float ka[S::NB], vb[S::NB];
#pragma unroll
        for (int a = 0; a < S::NB; ++a) ka[a] = ls[i * S::LDK + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < S::NB; ++b) vb[b] = vs[i * S::LDK + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < S::NB; ++a)
#pragma unroll
          for (int b = 0; b < S::NB; ++b) upd[a][b] = fmaf(ka[a], vb[b], upd[a][b]);
      }
#pragma unroll
      for (int a = 0; a < S::NB; ++a) {
        const int c = ty + 16 * a;
        const float decay = expf(lt[c]);
#pragma unroll
        for (int b = 0; b < S::NB; ++b) {
          float* cell = st + c * S::LDK + tx + 16 * b;
          *cell = *cell * decay + upd[a][b];
        }
      }
    }
  }
}

template <int C, int K, typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
           void* out, int bh, int t, cudaStream_t st) {
  const size_t smem = Shape<C, K>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(wkv_kernel<C, K, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_kernel<C, K, T><<<bh, kThreads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), u, static_cast<T*>(out), t);
  return (int)cudaGetLastError();
}

template <int K, typename T>
int by_chunk(int chunk, const void* r, const void* k, const void* v, const void* lw,
             const float* u, void* out, int bh, int t, cudaStream_t st) {
  switch (chunk) {
    case 16: return launch<16, K, T>(r, k, v, lw, u, out, bh, t, st);
    case 32: return launch<32, K, T>(r, k, v, lw, u, out, bh, t, st);
    case 64: return launch<64, K, T>(r, k, v, lw, u, out, bh, t, st);
    case 128: return launch<128, K, T>(r, k, v, lw, u, out, bh, t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_head(int kk, int chunk, const void* r, const void* k, const void* v, const void* lw,
            const float* u, void* out, int bh, int t, cudaStream_t st) {
  switch (kk) {
    case 16: return by_chunk<16, T>(chunk, r, k, v, lw, u, out, bh, t, st);
    case 32: return by_chunk<32, T>(chunk, r, k, v, lw, u, out, bh, t, st);
    case 64: return by_chunk<64, T>(chunk, r, k, v, lw, u, out, bh, t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  r, k, v, lw, out (bh, t, kk); u (bh, kk) f32.
extern "C" int wkv_v1_launch(const void* r, const void* k, const void* v, const void* lw,
                             const float* u, void* out, int dtype, int bh, int t, int kk,
                             int chunk, void* stream) {
  if (bh < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head<float>(kk, chunk, r, k, v, lw, u, out, bh, t, st);
  if (dtype == 1) return by_head<__nv_bfloat16>(kk, chunk, r, k, v, lw, u, out, bh, t, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wkv_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
