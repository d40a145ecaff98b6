// Flash attention forward at head dim 80 (hubert-xlarge: d 1280 / 16 heads)
// for NVIDIA Hopper (sm_90a): flash_attention.cu's two schedules, the bf16
// wgmma kernel (5 k-steps of m64n64k16 for Q K^T, m64n80k16 for P V) and the
// fp32 SIMT one, instantiated at D = 80 in a translation unit of their own.
// In flash_attention.cu they moved the compiler's code for the bf16 D = 128
// kernel; here that unit keeps the code it has without them.  Launched by
// flash_attention.cu's entry points for D = 80, with and without the rows'
// lse; a causal sliding window is taken by the fp32 schedule only (the bf16
// window kernel, flash_attention_window.cu, has no D = 80: no config runs a
// window at that head dim, and ops.py refuses it).
//
// Bound at hubert-xlarge's prefill shape (B 2, S 4096, H = KV = 16, bf16,
// bidirectional): 4*B*H*D*S^2 = 171.8 GFLOP, 0.174 ms at 989 TFLOP/s,
// against 84 MB of q, k, v and o (0.025 ms): bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_simt.cuh"
#include "flash_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"

int flash_attention_d80_f32(const float* q, const float* k, const float* v, float* o,
                            float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
                            int window, float scale, cudaStream_t stream) {
  return simt::launch_d<80>(q, k, v, o, lse, Sq, Sk, H, KV, B, causal, window, scale, stream);
}

int flash_attention_d80_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int B,
                             int Sq, int Sk, int H, int KV, int causal, float scale,
                             cudaStream_t stream) {
  return wg::launch_d<80>(q, k, v, o, lse, Sq, Sk, H, KV, B, causal, scale, stream);
}
