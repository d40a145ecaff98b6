// The bf16 wgmma schedule of the flash attention forward without a window
// (flash_attention.cu's header comment says how it works), on the building
// blocks of flash_wgmma.cuh.  Included by flash_attention.cu, which
// instantiates it for head dims 16, 32, 64 and 128, and by
// flash_attention_d80.cu (head dim 80): in one unit with the others, the
// D = 80 instantiation moved the compiler's code for the D = 128 one.
#pragma once

#include "flash_wgmma.cuh"

namespace {
namespace wg {

template <int D>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: 128 registers
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                int B, int Sq, int Sk, int H, int KV, int causal, float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "head dim: a multiple of 16, at most 128");
  constexpr uint32_t kTileKV = BKV * D * sizeof(bf16);
  constexpr uint32_t kRowGroup = 16 * D;  // bytes between 8-row groups of a tile
  extern __shared__ __align__(128) uint8_t tiles[];
  const uint32_t sQ = smem_addr(tiles);
  const uint32_t sK = sQ + BQ * D * sizeof(bf16);
  const uint32_t sV = sK + kStages * kTileKV;

  const int ntiles = (Sq + BQ - 1) / BQ;
  int tile = blockIdx.x / (H * B);
  if (causal) tile = ntiles - 1 - tile;
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int q0 = tile * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;            // warpgroup
  const int warp = (tid % 128) / 32;    // warp within it
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int offset = Sk - Sq;           // key position of q row 0

  const long long q_ld = (long long)H * D, kv_ld = (long long)KV * D;
  const bf16* qb = q + ((long long)b * Sq + q0) * q_ld + (long long)h * D;
  const bf16* kb = k + (long long)b * Sk * kv_ld + (long long)kvh * D;
  const bf16* vb = v + (long long)b * Sk * kv_ld + (long long)kvh * D;

  const int kv_end = causal ? min(Sk, offset + min(q0 + BQ, Sq)) : Sk;
  const int n_kv = (kv_end + BKV - 1) / BKV;

  load_tile<BQ, D>(sQ, qb, Sq - q0, q_ld, tid);
  load_tile<BKV, D>(sK, kb, Sk, kv_ld, tid);
  load_tile<BKV, D>(sV, vb, Sk, kv_ld, tid);
  cp_async_commit();

  // this warpgroup's rows, and the two rows of this thread's fragment
  const int wq0 = q0 + 64 * wgi;
  const int wg_rows = min(64, Sq - wq0);            // <= 0: a ragged block's idle half
  const int wg_last = offset + wq0 + wg_rows - 1;   // key position of its last row
  const int row0 = wq0 + 16 * warp + lane / 4;      // and row0 + 8
  const int pos0 = offset + row0;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t qa = sQ + 8 * kRowGroup * wgi;     // this warpgroup's 64 q rows

  for (int j = 0; j < n_kv; ++j) {
    const int stage = j % kStages;
    if (j + 1 < n_kv) {
      const int k1 = (j + 1) * BKV;
      const uint32_t next = ((j + 1) % kStages) * kTileKV;
      load_tile<BKV, D>(sK + next, kb + k1 * kv_ld, Sk - k1, kv_ld, tid);
      load_tile<BKV, D>(sV + next, vb + k1 * kv_ld, Sk - k1, kv_ld, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copies just issued has landed
    fence_proxy_async();
    __syncthreads();

    const int k0 = j * BKV;
    if (wg_rows > 0 && (!causal || k0 <= wg_last)) {
      // S = Q K^T: 64 x 64 fp32 per warpgroup
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, make_desc(qa + 256 * kk, 128, kRowGroup),
                     make_desc(sK + stage * kTileKV + 256 * kk, 128, kRowGroup), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // s[8n + e] is (row0, key k0 + 8n + 2 quad + e), s[8n + 2 + e] (row0 + 8, same key)
      if (k0 + BKV > Sk || (causal && k0 + BKV - 1 > offset + wq0)) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + 8 * n + 2 * quad + e;
            if (kj >= Sk || (causal && kj > pos0)) s[4 * n + e] = kNegInf;
            if (kj >= Sk || (causal && kj > pos0 + 8)) s[4 * n + 2 + e] = kNegInf;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        mx[r] *= scale_log2;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[4 * n + e], scale_log2, -mx[e / 2]));
          s[4 * n + e] = p;
          sum[e / 2] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];  // this lane's share
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= corr[0];
        acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1];
        acc[4 * n + 3] *= corr[1];
      }

      // O += P V, P = hi + lo as two bf16 A fragments (keys 16kk..16kk+15
      // from s[8kk..8kk+7]): hi alone would carry 2^-9 of each weight into o
      uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p0 = s[8 * kk + 2 * r], p1 = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 back = __bfloat1622float2(hi);
          ph[kk][r] = bits(hi);
          pl[kk][r] = bits(__floats2bfloat162_rn(p0 - back.x, p1 - back.y));
        }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t keys = sV + stage * kTileKV + 2 * kRowGroup * kk;  // 16kk..
        const uint64_t vt = make_desc(keys, kRowGroup, 128);
        WgmmaRS<D>::run(acc, ph[kk], vt);
        WgmmaRS<D>::run(acc, pl[kk], vt);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    }
    __syncthreads();  // this stage is read; the next round refills it
  }

  if (wg_rows <= 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && quad == 0)
      lse[((long long)b * H + h) * Sq + qi] = (m[r] * scale_log2 + log2f(denom)) * kLn2;
    bf16* row = o + (((long long)b * Sq + qi) * H + h) * D + 2 * quad;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) = __floats2bfloat162_rn(
          acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
  }
}

template <int D>
int launch_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int Sq,
             int Sk, int H, int KV, int B, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((Sq + BQ - 1) / BQ) * H * B;
  flash_fwd_wgmma<D><<<blocks, kThreads, bytes, stream>>>(q, k, v, o, lse, B, Sq, Sk, H,
                                                          KV, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace
