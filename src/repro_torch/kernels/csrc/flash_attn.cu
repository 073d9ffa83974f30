// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attn/kernel.py::flash_attention_pallas (the
// Pallas TPU kernel, body _flash_kernel at :36) and computes what it does:
// per query row, softmax(q k^T * sm_scale) v over the keys it sees, with a
// causal mask (k_pos <= q_pos) and a sliding window (k_pos > q_pos -
// window), masked scores at NEG, p masked to 0 after the exp, f32 running
// max m, sum l and accumulator, and out = acc / max(l, 1e-30), so a row
// with no visible key gives 0.  Ragged Sq and Skv need no padding; GQA
// without a copy (query head bh reads kv head bh / group).  Two kernels:
//
// f32: flash_simt::flash_attn_kernel (flash_attn_simt.cuh), fp32 FMAs.
//
// bf16: flash_mma::flash_attn_mma_kernel below, on the tensor cores.  The
// Pallas kernel's two products are bf16 x bf16 with an f32 accumulator
// (preferred_element_type=f32): exactly mma.sync.m16n8k16.f32.bf16.bf16.
// s = (q k^T accumulated in f32) * sm_scale, the scale applied to the f32
// accumulator; l sums the f32 p, and only the PV product takes p rounded
// to bf16 (the Pallas kernel's p.astype(v.dtype)).
//
// Design (FlashAttention-2's shape): one CTA of 4 warps per (bh, q tile),
// each warp owning MT m16 tiles of query rows (MT = 2, a 128-row q tile,
// up to hd 128; MT = 1, 64 rows, at hd 256, where the (16, 256) f32
// accumulator alone takes 128 registers a thread); the kv walk is a loop
// inside the CTA.  K and V tiles of BK keys (64; 32 at hd 256) are
// double-buffered in shared memory by cp.async (16 B, zero-filled past
// Skv, so no stale NaN meets a zero p), rows padded by 16 B so every
// ldmatrix phase hits 32 distinct banks.  QK^T: Q's A fragments by
// ldmatrix, re-read at each k-step; K's B fragments by ldmatrix as K lies
// (hd-contiguous rows are the col-major B operand), each B fragment
// feeding the warp's MT mmas.  The (16 MT, BK)
// score tile stays in f32 registers in the mma C layout; the row max and
// row sum are reduced over the 4 lanes of a quad with shuffles, and the C
// fragment becomes PV's A fragment by packing p to bf16 pairs, with no
// trip through shared memory.  V's B fragments come by ldmatrix.trans.
// kv tiles fully masked for the whole q tile (above the causal diagonal,
// behind the window, past Skv) are skipped, and tiles fully visible to it
// skip the per-element mask.  q tiles are launched heaviest first across
// all heads (grid x = bh, y = q tile).
//
// Bound: operations.  At qwen3-0.6b's train shape (B 2, H 16, S 4096,
// hd 128, causal) the visible pairs need 1.37e11 flop: 0.139 ms at the
// 989 TFLOP/s dense bf16 rate, against 1.0e8 B of q, k, v and out (0.03
// ms at 3.35 TB/s).  mma.sync reaches a part of that rate (wgmma with TMA
// is the step to all of it).  Shared memory feeds the B fragments (256 B
// a mma over MT), which is why two m16 tiles a warp beat one, and the
// softmax's f32 work (one ex2 per score) runs beside the mmas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_attn_simt.cuh"

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Cfg {
  static constexpr int MT = HD == 256 ? 1 : 2;     // m16 tiles a warp (a B fragment feeds MT)
  static constexpr int BQ = 16 * MT * kWarps;      // query rows a CTA
  static constexpr int BK = HD == 256 ? 32 : 64;   // keys a kv tile
  static constexpr int LD = HD + 8;                // smem row pitch in bf16 (16 B of padding)
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)LD * (BQ + 4 * BK);  // Q, 2 x (K, V)
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of a (n_valid, HD) matrix into shared memory at
// pitch LD; rows at or past n_valid are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n_valid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  constexpr int kIters = (ROWS * kChunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int idx = it * kThreads + (int)threadIdx.x;
    if (idx < ROWS * kChunks) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      const bool ok = row0 + r < n_valid;
      cp_async16(dst + r * Cfg<HD>::LD + c, ok ? src + (size_t)(row0 + r) * HD + c : src, ok);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t.  A: a0 (row g,
// cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8,
// cols 2t+8..).  B: b0 (k rows 2t, 2t+1, col g), b1 (k rows 2t+8, 2t+9).
// C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).  So a thread holds
// two query rows (g, g+8) of each of its warp's MT m16 tiles, at keys
// 8 nt + 2t (+1).
//
// The softmax runs in the exp2 domain: the f32 accumulator times c =
// sm_scale * log2(e) is the score in units of ln 2, so exp(s - m) =
// 2^(x - m') with x = c (q k^T) and m' its running max; masked scores are
// NEG and their p is 0, as the Pallas kernel's.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int sq, int skv,
                      int group, int causal, int window, float sm_scale) {
  using C = Cfg<HD>;
  constexpr int MT = C::MT, BQ = C::BQ, BK = C::BK, LD = C::LD;
  constexpr int NT = BK / 8;   // n8 tiles of the score tile
  constexpr int KQ = HD / 16;  // k16 steps of QK^T
  constexpr int NO = HD / 8;   // n8 tiles of the output
  constexpr int KV = BK / 16;  // k16 steps of PV
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * LD;  // two stages of BK rows
  bf16* vs = ks + 2 * BK * LD;

  const int bh = blockIdx.x;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;  // heavy first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = sm_scale * kLog2e;
  const bf16* qh = q + (size_t)bh * sq * HD;
  const bf16* kh = k + (size_t)(bh / group) * skv * HD;
  const bf16* vh = v + (size_t)(bh / group) * skv * HD;
  bf16* oh = out + (size_t)bh * sq * HD;

  // kv tiles that can hold a visible key for some row of this q tile
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : kt_begin;
  const int row0 = q0 + warp * 16 * MT + g;  // rows row0 + 16 mi + {0, 8}

  float acc[MT][NO][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mi][i] = -INFINITY;
      l[mi][i] = 0.f;
    }
  }

  if (kt_begin < kt_end) {
    load_rows<HD, BQ>(qs, qh, q0, sq);
    load_rows<HD, BK>(ks, kh, kt_begin * BK, skv);
    load_rows<HD, BK>(vs, vh, kt_begin * BK, skv);
    cp_async_commit();
  }
  // this lane's ldmatrix row of Q (A operand: rows lane % 16, cols 8 (lane / 16))
  const bf16* qa = qs + (warp * 16 * MT + (lane & 15)) * LD + (lane >> 4) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // the next tile's load in flight during this one
      load_rows<HD, BK>(ks + (stage ^ 1) * BK * LD, kh, (kt + 1) * BK, skv);
      load_rows<HD, BK>(vs + (stage ^ 1) * BK * LD, vh, (kt + 1) * BK, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kst = ks + stage * BK * LD;
    const bf16* vst = vs + stage * BK * LD;

    // s = q k^T: B fragments of key tiles nt, nt + 1 (rows lane % 8 + 8 (lane / 16),
    // cols 8 ((lane / 8) % 2)) in one ldmatrix.x4, each used by the MT m16 tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldsm_x4(a[mi], qa + mi * 16 * LD + kk * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        unsigned b[4];
        ldsm_x4(b, kst + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(s[mi][nt], a[mi], b[0], b[1]);
          mma_bf16(s[mi][nt + 1], a[mi], b[2], b[3]);
        }
      }
    }

    // scale, mask and online softmax on the f32 tile
    const int k0 = kt * BK;
    const bool full = k0 + BK <= skv && (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || k0 > q_last - window);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mi][nt][e] * c;
          if (!full) {
            const int qp = row0 + mi * 16 + (e >> 1) * 8, kp = k0 + nt * 8 + 2 * t + (e & 1);
            if (!(kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window)))
              x = kNeg;
          }
          s[mi][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      // A masked score's p is 0: 2^(NEG - m) underflows to 0 once the row has
      // seen a visible key, and while it has not (m = NEG) m is taken as
      // +inf, so every p of the row is 2^-inf = 0.
      float alpha[2], m_sub[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[mi][i], mx[i]);
        alpha[i] = ex2(m[mi][i] - m_new);  // 0 on the first tile: m = -inf
        m[mi][i] = m_new;
        m_sub[i] = m_new == kNeg ? INFINITY : m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[mi][nt][e] - m_sub[e >> 1]);
          s[mi][nt][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[mi][i] = l[mi][i] * alpha[i] + rs[i];  // this lane's part
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[mi][n][0] *= alpha[0];
        acc[mi][n][1] *= alpha[0];
        acc[mi][n][2] *= alpha[1];
        acc[mi][n][3] *= alpha[1];
      }
    }

    // acc += bf16(p) v: p's C fragments of key tiles 2 kk, 2 kk + 1 are the A
    // fragment of k-step kk; V's B fragments of output tiles n, n + 1 by
    // ldmatrix.trans (rows lane % 8 + 8 ((lane / 8) % 2), cols 8 (lane / 16))
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        a[mi][0] = pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
        a[mi][1] = pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
        a[mi][2] = pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
        a[mi][3] = pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned b[4];
        ldsm_x4_trans(b, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n * 8 +
                             (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][n], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][n + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is read: the next iteration's load may refill it
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float row_l = l[mi][i];
      row_l += __shfl_xor_sync(kFull, row_l, 1);
      row_l += __shfl_xor_sync(kFull, row_l, 2);
      const int qp = row0 + mi * 16 + i * 8;
      if (qp >= sq) continue;
      const float denom = fmaxf(row_l, 1e-30f);
      bf16* orow = oh + (size_t)qp * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[mi][n][2 * i] / denom, acc[mi][n][2 * i + 1] / denom);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int sq, int skv,
           int group, int causal, int window, float sm_scale, cudaStream_t st) {
  const size_t smem = Cfg<HD>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)bh, (unsigned)((sq + Cfg<HD>::BQ - 1) / Cfg<HD>::BQ));
  flash_attn_mma_kernel<HD><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, skv, group, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

int dispatch(int hd, const void* q, const void* k, const void* v, void* out, int bh, int sq,
             int skv, int group, int causal, int window, float sm_scale, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 64: return launch<64>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 128: return launch<128>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 256: return launch<256>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_mma

// dtype: 0 = f32 (fp32 FMAs), 1 = bf16 (tensor cores).  q, out (bh, sq, hd);
// k, v (bh / group, skv, hd).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 int dtype, int bh, int sq, int skv, int hd, int group,
                                 int causal, int window, float sm_scale, void* stream) {
  if (bh < 1 || sq < 1 || skv < 0 || group < 1 || bh % group || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash_simt::dispatch<float>(hd, q, k, v, out, bh, sq, skv, group, causal, window,
                                       sm_scale, st);
  if (dtype == 1)
    return flash_mma::dispatch(hd, q, k, v, out, bh, sq, skv, group, causal, window, sm_scale,
                               st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
