// The fp32 SIMT schedule of the flash attention forward (flash_attention.cu's
// header comment says how it works).  Included by flash_attention.cu, which
// instantiates it for head dims 16, 32, 64 and 128, and by
// flash_attention_d80.cu, which instantiates it for head dim 80.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// fp32: the SIMT schedule
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KV,
          int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1;       // padded row of the q and k tiles
  constexpr int LP = BK + 1;      // padded row of the probability tile
  constexpr int NJ = D / 16;      // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x LD, pre-scaled fp32 q
  float* Ks = Qs + BQ * LD;       // BK x LD
  float* Vs = Ks + BK * LD;       // BK x D
  float* Ps = Vs + BK * D;        // BQ x LP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int offset = Sk - Sq;     // key position of q row 0

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    float val = 0.f;
    if (qi < Sq) val = to_f(q[(((size_t)b * Sq + qi) * H + h) * D + d]) * scale;
    Qs[r * LD + d] = val;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int kv_end = Sk;
  int kv_begin = 0;
  const int win = kWindow && causal ? window : 0;
  if (causal) {
    const int last_q = min(q0 + BQ, Sq) - 1;
    kv_end = min(Sk, offset + last_q + 1);
    if (win > 0) kv_begin = max(0, offset + q0 - win + 1) / BK * BK;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int kj = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (kj < Sk) {
        const size_t g = (((size_t)b * Sk + kj) * KV + kvh) * D + d;
        kval = to_f(k[g]);
        vval = to_f(v[g]);
      }
      Ks[r * LD + d] = kval;
      Vs[r * D + d] = vval;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = offset + q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= Sk || (causal && qpos < kj) || (win > 0 && qpos - kj >= win))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      // a row that has seen no key yet: its masked scores weigh 0
      const float m_sub = (win > 0 && m_new == kNegInf) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_sub);
        sum += p;
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a thread's rows are written by the 16 lanes of its warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(denom);
    T* row = o + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <int D, bool kWindow>
int launch_w(const float* q, const float* k, const float* v, float* o, float* lse, int Sq,
             int Sk, int H, int KV, int B, int causal, int window, float scale,
             cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<float, D, kWindow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<float, D, kWindow><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, lse, Sq, Sk, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const float* q, const float* k, const float* v, float* o, float* lse, int Sq,
             int Sk, int H, int KV, int B, int causal, int window, float scale,
             cudaStream_t stream) {
  if (causal && window > 0)
    return launch_w<D, true>(q, k, v, o, lse, Sq, Sk, H, KV, B, causal, window, scale, stream);
  return launch_w<D, false>(q, k, v, o, lse, Sq, Sk, H, KV, B, causal, 0, scale, stream);
}

}  // namespace simt

}  // namespace
