// The first design of flash_attn's f32 and bf16 paths: the fp32-FMA kernel
// of flash_attn_simt.cuh, with T = float or T = bf16 (q, k and v converted
// to f32 on load).  On no path of the port: chip_smoke.py times it beside
// the tensor-core kernels of flash_attn.cu that replaced it (3xTF32 for
// f32, bf16 mma.sync for bf16), on the same inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../flash_attn_simt.cuh"

// dtype: 0 = f32, 1 = bf16.  q, out (bh, sq, hd); k, v (bh / group, skv, hd);
// hd 32, 64, 128 or 256.
extern "C" int flash_attn_v1_launch(const void* q, const void* k, const void* v, void* out,
                                    int dtype, int bh, int sq, int skv, int hd, int group,
                                    int causal, int window, float sm_scale, void* stream) {
  if (bh < 1 || sq < 1 || skv < 0 || group < 1 || bh % group || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash_simt::dispatch<float>(hd, q, k, v, out, bh, sq, skv, group, causal, window,
                                       sm_scale, st);
  if (dtype == 1)
    return flash_simt::dispatch<__nv_bfloat16>(hd, q, k, v, out, bh, sq, skv, group, causal,
                                               window, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
