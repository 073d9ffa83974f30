// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attn/kernel.py::flash_attention_pallas (the
// Pallas TPU kernel, body _flash_kernel at :36) and computes what it does:
// per query row, softmax(q k^T * sm_scale) v over the keys it sees, with a
// causal mask (k_pos <= q_pos) and a sliding window (k_pos > q_pos -
// window), masked scores at NEG, p masked to 0 after the exp, f32 running
// max m, sum l and accumulator, and out = acc / max(l, 1e-30), so a row
// with no visible key gives 0.  Ragged Sq and Skv need no padding; GQA
// without a copy (query head bh reads kv head bh / group).  Head widths
// 16, 32, 64, 128 and 256 (the wrapper pads any other width up to one of
// them with zero columns).  Two kernels, both on the tensor cores:
//
// f32: flash_tf32::flash_attn_tf32_kernel below, 3xTF32 (see there).  Its
// first design, fp32 FMAs, is flash_attn_simt.cuh (csrc/legacy/).
//
// bf16: flash_mma::flash_attn_mma_kernel below.  The
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

namespace flash_common {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of a (n_valid, HD) matrix of T into shared
// memory at pitch LD (elements), by the NT threads of the CTA; rows at or
// past n_valid are zero-filled.
template <typename T, int HD, int LD, int ROWS, int NT = kThreads>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int n_valid) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  constexpr int kChunks = HD / kPer;         // chunks a row
  constexpr int kIters = (ROWS * kChunks + NT - 1) / NT;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int idx = it * NT + (int)threadIdx.x;
    if (idx < ROWS * kChunks) {
      const int r = idx / kChunks, c = (idx % kChunks) * kPer;
      const bool ok = row0 + r < n_valid;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(row0 + r) * HD + c : src, ok);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace flash_common

namespace flash_mma {

using namespace flash_common;
using bf16 = __nv_bfloat16;

template <int HD>
struct Cfg {
  static constexpr int MT = HD == 256 ? 1 : 2;     // m16 tiles a warp (a B fragment feeds MT)
  static constexpr int BQ = 16 * MT * kWarps;      // query rows a CTA
  static constexpr int BK = HD == 256 ? 32 : 64;   // keys a kv tile
  static constexpr int LD = HD + 8;                // smem row pitch in bf16 (16 B of padding)
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)LD * (BQ + 4 * BK);  // Q, 2 x (K, V)
};

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
    load_rows<bf16, HD, LD, BQ>(qs, qh, q0, sq);
    load_rows<bf16, HD, LD, BK>(ks, kh, kt_begin * BK, skv);
    load_rows<bf16, HD, LD, BK>(vs, vh, kt_begin * BK, skv);
    cp_async_commit();
  }
  // this lane's ldmatrix row of Q (A operand: rows lane % 16, cols 8 (lane / 16))
  const bf16* qa = qs + (warp * 16 * MT + (lane & 15)) * LD + (lane >> 4) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // the next tile's load in flight during this one
      load_rows<bf16, HD, LD, BK>(ks + (stage ^ 1) * BK * LD, kh, (kt + 1) * BK, skv);
      load_rows<bf16, HD, LD, BK>(vs + (stage ^ 1) * BK * LD, vh, (kt + 1) * BK, skv);
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
    case 16: return launch<16>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 32: return launch<32>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 64: return launch<64>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 128: return launch<128>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 256: return launch<256>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_mma

namespace flash_tf32 {

// The f32 path: the Pallas kernel's two products are f32 x f32 (its
// preferred_element_type=f32 on f32 inputs).  Here each is three TF32
// products on the tensor cores, mma.sync.m16n8k8.f32.tf32.tf32.f32: every
// operand x splits into hi = tf32(x), rounded to nearest, and lo = x - hi
// (exact in f32), and a.b = a_hi.b_lo + a_lo.b_hi + a_hi.b_hi, the two
// small terms accumulated before the large one (CUTLASS's 3xTF32).  lo goes
// to the mma as it is: the tensor core reads a tf32 operand's top 19 bits,
// so lo is truncated to tf32 there, for free, as CUTLASS's fast 3xTF32
// lets it be.  What is dropped, a_lo.b_lo and lo's truncation, is at most
// about 2^-21 of each product: f32's accuracy, where one TF32 product
// (2^-11) is not.  The scale goes on the f32 accumulator; m, l and acc stay
// f32; out = acc / max(l, 1e-30).
//
// Design: flash_mma's shape (one CTA per (bh, q tile), MT m16 tiles a
// warp, K and V tiles double-buffered by cp.async and zero-filled past
// Skv, the online softmax on the C fragments in registers with quad
// shuffles, masked tiles skipped, fully visible ones unmasked, q tiles
// heaviest first), with f32 tiles in shared memory, split at fragment
// load.  The split and the fragment moves are most of what a warp issues
// beside its mmas, so the shape is set for the issue rate: two CTAs of 4
// warps an SM at hd <= 128 (two m16 tiles a warp: a K or V fragment split
// once feeds both; 16-key tiles at hd 128, 32 below, keep Q, K and V
// within half of shared memory), one CTA of 8 warps at hd 256 (one m16
// tile a warp, the (16, 256) f32 accumulator alone 128 registers).  One barrier a tile: the
// next tile's copy is issued after it, into the stage the last tile read.
//   - QK^T: the sum over hd runs in a permuted order, so that one 16-byte
//     load serves two k8 steps: in the 16 columns of block kb, A's column t
//     of step 0 is column 4t, t + 4 is 4t + 1, and step 1 takes 4t + 2 and
//     4t + 3; K's B fragments (K as it lies is the col-major B operand)
//     take the same order.  Q and K rows are at a pitch of 16 mod 32
//     floats: the 8 lanes of each quarter-warp of a 16-byte load hit 32
//     distinct banks.
//   - PV: p's C fragment (row g, keys 2t, 2t + 1) becomes the A fragment
//     of a k8 step with key 2t as column t and key 2t + 1 as column t + 4,
//     no shuffle; so V's B fragment reads V rows 2t and 2t + 1.  One
//     16-byte load of row 2t (VW = 4 columns) feeds VW n8 output tiles,
//     tile e taking column VW g + e; the output columns a lane ends with
//     are then 2 VW consecutive ones, stored as float4s.  V's pitch is
//     4 mod 16 floats, so rows 2t land 8 banks apart.
//
// Bound: operations.  At qwen3-0.6b's train shape (B 2, H 16, S 4096,
// hd 128, causal) the visible pairs need 1.37e11 flop; three TF32 products
// for each make 4.1e11 at 495 TFLOP/s dense: 0.834 ms (2.05 ms for the
// same 1.37e11 in fp32 FMAs, the first design's bound).

using namespace flash_common;

template <int HD>
struct Cfg {
  static constexpr int WARPS = HD >= 256 ? 8 : 4;  // warps a CTA
  static constexpr int MT = HD >= 256 ? 1 : 2;     // m16 tiles a warp
  static constexpr int BK = HD >= 128 ? 16 : 32;   // keys a kv tile
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MT * WARPS;       // query rows a CTA
  static constexpr int LDK = HD % 32 ? HD : HD + 16;  // Q and K pitch (floats), 16 mod 32
  static constexpr int LDV = HD + 4;                  // V pitch, 4 mod 16
  static constexpr int VW = HD >= 32 ? 4 : 2;         // V columns a lane loads at once
  static constexpr size_t kSmem = sizeof(float) * ((size_t)BQ * LDK + 2 * (size_t)BK * (LDK + LDV));
  static_assert(HD % 16 == 0 && HD % (8 * VW) == 0, "head width");
};

// d += a (16 x 8, row) * b (8 x 8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 fraction bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x, in two integer operations (an add of half
// the dropped bits' range to the magnitude, a mask); the cvt itself
// compiles to about five, with its NaN and infinity cases.
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo exactly; hi in tf32, lo in f32 (the mma reads it as tf32).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b in 3xTF32: the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                     unsigned bl0, unsigned bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// VW consecutive floats of two rows LD apart.
template <int VW>
__device__ __forceinline__ void load_pair(float (&a)[VW], float (&b)[VW], const float* p, int ld) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    const float4 y = *reinterpret_cast<const float4*>(p + ld);
    a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
    b[0] = y.x, b[1] = y.y, b[2] = y.z, b[3] = y.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    const float2 y = *reinterpret_cast<const float2*>(p + ld);
    a[0] = x.x, a[1] = x.y;
    b[0] = y.x, b[1] = y.y;
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane = 4 g + t.  A: a0
// (row g, col t), a1 (row g + 8, col t), a2 (row g, col t + 4), a3 (row
// g + 8, col t + 4).  B: b0 (k row t, col g), b1 (k row t + 4, col g).  C:
// c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8).
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::WARPS > 4 ? 1 : 2)
flash_attn_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int sq, int skv,
                       int group, int causal, int window, float sm_scale) {
  using C = Cfg<HD>;
  constexpr int MT = C::MT, BQ = C::BQ, BK = C::BK, LDK = C::LDK, LDV = C::LDV, VW = C::VW;
  constexpr int NTH = C::THREADS;
  constexpr int NT = BK / 8;         // n8 key tiles of the score tile = k8 steps of PV
  constexpr int KB = HD / 16;        // 16-column blocks of QK^T (two k8 steps each)
  constexpr int NG = HD / (8 * VW);  // groups of VW n8 output tiles
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);   // Q
  float* ks = qs + BQ * LDK;                       // two stages of BK rows
  float* vs = ks + 2 * BK * LDK;

  const int bh = blockIdx.x;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;  // heavy first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = sm_scale * kLog2e;
  const float* qh = q + (size_t)bh * sq * HD;
  const float* kh = k + (size_t)(bh / group) * skv * HD;
  const float* vh = v + (size_t)(bh / group) * skv * HD;
  float* oh = out + (size_t)bh * sq * HD;

  // kv tiles that can hold a visible key for some row of this q tile
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : kt_begin;
  const int row0 = q0 + warp * 16 * MT + g;  // rows row0 + 16 mi + {0, 8}

  float acc[MT][HD / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mi][i] = -INFINITY;
      l[mi][i] = 0.f;
    }
  }

  if (kt_begin < kt_end) {
    load_rows<float, HD, LDK, BQ, NTH>(qs, qh, q0, sq);
    load_rows<float, HD, LDK, BK, NTH>(ks, kh, kt_begin * BK, skv);
    load_rows<float, HD, LDV, BK, NTH>(vs, vh, kt_begin * BK, skv);
    cp_async_commit();
  }
  // this lane's 16-byte slot of Q row g (+ 8) in each 16-column block
  const float* qa = qs + (warp * 16 * MT + g) * LDK + 4 * t;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait<0>();  // this tile (and, the first time, Q) is in
    __syncthreads();     // for every thread; and every warp is done with the last tile
    if (kt + 1 < kt_end) {  // the next tile's copy, into the stage the last tile read
      load_rows<float, HD, LDK, BK, NTH>(ks + (stage ^ 1) * BK * LDK, kh, (kt + 1) * BK, skv);
      load_rows<float, HD, LDV, BK, NTH>(vs + (stage ^ 1) * BK * LDV, vh, (kt + 1) * BK, skv);
      cp_async_commit();
    }
    const float* kst = ks + stage * BK * LDK;
    const float* vst = vs + stage * BK * LDV;

    // s = q k^T, two k8 steps per 16-column block
    float s[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][nt][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      unsigned ah[MT][2][4], al[MT][2][4];  // [m16 tile][k8 step][register]
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* p0 = qa + mi * 16 * LDK + kb * 16;
        const float4 x0 = *reinterpret_cast<const float4*>(p0);             // row g
        const float4 x1 = *reinterpret_cast<const float4*>(p0 + 8 * LDK);   // row g + 8
        const float xs[2][4] = {{x0.x, x1.x, x0.y, x1.y}, {x0.z, x1.z, x0.w, x1.w}};
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int r = 0; r < 4; ++r) split(xs[st][r], ah[mi][st][r], al[mi][st][r]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 y = *reinterpret_cast<const float4*>(kst + (nt * 8 + g) * LDK + kb * 16 + 4 * t);
        unsigned bhi[4], blo[4];  // step 0: b0, b1; step 1: b0, b1
        split(y.x, bhi[0], blo[0]);
        split(y.y, bhi[1], blo[1]);
        split(y.z, bhi[2], blo[2]);
        split(y.w, bhi[3], blo[3]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma3(s[mi][nt], ah[mi][0], al[mi][0], bhi[0], bhi[1], blo[0], blo[1]);
          mma3(s[mi][nt], ah[mi][1], al[mi][1], bhi[2], bhi[3], blo[2], blo[3]);
        }
      }
    }

    // scale, mask and online softmax on the f32 tile, in the exp2 domain
    // (x = c (q k^T), c = sm_scale log2(e)), as flash_mma's
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
      float alpha[2], m_sub[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[mi][i], mx[i]);
        alpha[i] = ex2(m[mi][i] - m_new);  // 0 on the first tile: m = -inf
        m[mi][i] = m_new;
        m_sub[i] = m_new == kNeg ? INFINITY : m_new;  // no visible key yet: every p is 0
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
      for (int n = 0; n < HD / 8; ++n) {
        acc[mi][n][0] *= alpha[0];
        acc[mi][n][1] *= alpha[0];
        acc[mi][n][2] *= alpha[1];
        acc[mi][n][3] *= alpha[1];
      }
    }

    // acc += p v: key tile nt is k8 step nt, key 2t as column t and 2t + 1
    // as column t + 4; V rows 2t and 2t + 1, VW columns a load
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      unsigned ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        split(s[mi][nt][0], ph[mi][0], pl[mi][0]);
        split(s[mi][nt][2], ph[mi][1], pl[mi][1]);
        split(s[mi][nt][1], ph[mi][2], pl[mi][2]);
        split(s[mi][nt][3], ph[mi][3], pl[mi][3]);
      }
      const float* v0 = vst + (nt * 8 + 2 * t) * LDV + VW * g;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        float x0[VW], x1[VW];  // rows 2t, 2t + 1
        load_pair<VW>(x0, x1, v0 + j * 8 * VW, LDV);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          unsigned hi0, lo0, hi1, lo1;
          split(x0[e], hi0, lo0);
          split(x1[e], hi1, lo1);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            mma3(acc[mi][j * VW + e], ph[mi], pl[mi], hi0, hi1, lo0, lo1);
        }
      }
    }
  }

  // output tile j VW + e holds, in c0 (c2) and c1 (c3), the columns
  // 8 VW j + VW (2t) + e and 8 VW j + VW (2t + 1) + e: 2 VW consecutive ones
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
      float* orow = oh + (size_t)qp * HD + 2 * t * VW;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        float o[2 * VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          o[e] = acc[mi][j * VW + e][2 * i] / denom;
          o[VW + e] = acc[mi][j * VW + e][2 * i + 1] / denom;
        }
#pragma unroll
        for (int h = 0; h < 2 * VW; h += 4)
          *reinterpret_cast<float4*>(orow + j * 8 * VW + h) =
              make_float4(o[h], o[h + 1], o[h + 2], o[h + 3]);
      }
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int sq, int skv,
           int group, int causal, int window, float sm_scale, cudaStream_t st) {
  const size_t smem = Cfg<HD>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)bh, (unsigned)((sq + Cfg<HD>::BQ - 1) / Cfg<HD>::BQ));
  flash_attn_tf32_kernel<HD><<<grid, Cfg<HD>::THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, skv, group, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

int dispatch(int hd, const void* q, const void* k, const void* v, void* out, int bh, int sq,
             int skv, int group, int causal, int window, float sm_scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 32: return launch<32>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 64: return launch<64>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 128: return launch<128>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 256: return launch<256>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_tf32

// dtype: 0 = f32 (3xTF32), 1 = bf16.  q, out (bh, sq, hd); k, v (bh /
// group, skv, hd); hd 16, 32, 64, 128 or 256.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 int dtype, int bh, int sq, int skv, int hd, int group,
                                 int causal, int window, float sm_scale, void* stream) {
  if (bh < 1 || sq < 1 || skv < 0 || group < 1 || bh % group || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash_tf32::dispatch(hd, q, k, v, out, bh, sq, skv, group, causal, window, sm_scale,
                                st);
  if (dtype == 1)
    return flash_mma::dispatch(hd, q, k, v, out, bh, sq, skv, group, causal, window, sm_scale,
                               st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
