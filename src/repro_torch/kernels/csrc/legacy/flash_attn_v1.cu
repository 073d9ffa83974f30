// The first design of flash_attn's bf16 path: the fp32-FMA kernel
// of flash_attn_simt.cuh with T = bf16, converting q, k and v to f32 on
// load.  On no path of the port: chip_smoke.py times it beside the
// tensor-core kernel of flash_attn.cu that replaced it, on the same inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../flash_attn_simt.cuh"

// q, out (bh, sq, hd) bf16; k, v (bh / group, skv, hd) bf16.
extern "C" int flash_attn_v1_launch(const void* q, const void* k, const void* v, void* out,
                                    int bh, int sq, int skv, int hd, int group, int causal,
                                    int window, float sm_scale, void* stream) {
  if (bh < 1 || sq < 1 || skv < 0 || group < 1 || bh % group || bh > 65535)
    return (int)cudaErrorInvalidValue;
  return flash_simt::dispatch<__nv_bfloat16>(hd, q, k, v, out, bh, sq, skv, group, causal,
                                             window, sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attn_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
