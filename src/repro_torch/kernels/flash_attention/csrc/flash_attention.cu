// Flash attention forward for NVIDIA Hopper (sm_90a).
//
//   o = softmax(q k^T / sqrt(D) [causal]) v     q (B,Sq,H,D), k/v (B,Sk,KV,D),
//                                               o (B,Sq,H,D) in q's dtype
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention (Pallas body `_kernel`).  Same function: online softmax
// with an fp32 running max m, denominator l and accumulator, q scaled by
// 1/sqrt(D) in fp32, o = acc / max(l, 1e-30) cast to q's dtype.  Causal rows
// sit at key positions (Sk - Sq) + i, as in models/layers.py's attention.
//
// Design.  One block of 256 threads per (q tile of 64 rows, q head, batch).
// The Pallas kernel carries (m, l, acc) across a sequential KV grid axis in
// VMEM; here the KV loop runs inside the block and the state lives in
// registers: thread (ty, tx) = (tid / 16, tid % 16) owns rows 4ty..4ty+3 and
// the columns tx + 16j of both the 64 x 64 score tile and the 64 x D
// accumulator, so a row's max and sum are shuffles within 16 lanes of one
// warp and no state crosses warps.  Shared memory holds the fp32 q tile,
// one K and one V tile (64 keys) and the probabilities of the tile
// (115 KB at D = 128, rows padded by one float against bank conflicts).
// The layout is the model's own: q head h reads KV head h / (H / KV) in
// place, so neither the GQA repeat nor the (B*H, S, D) transpose of the
// Pallas wrapper (ops.py:26-32) is materialised.  Ragged Sq and Sk are
// masked (the Pallas kernel asserts S % bq == 0).  Causal blocks stop at the
// diagonal: a q tile reads keys up to its last row's position only.
//
// Bound (published H100 SXM peaks at its 700 W limit).  At the qwen3-0.6b
// prefill shape (B 2, S 4096, H 16, KV 8, D 128, bf16, causal) the work is
// 2*2*B*H*S^2*D/2 = 137 GFLOP against ~101 MB of q, k, v and o: ~0.14 ms
// at the 989 TFLOP/s of bf16 tensor cores, so the kernel is bound by
// operations.  This first design does them in fp32 on the CUDA cores (FMA,
// no TF32, full-precision expf), which keeps the fp32 tolerance of 2e-5 but
// caps it at the 67 TFLOP/s fp32 rate; wgmma on bf16 tiles is later work.
//
// Launch: on the caller's stream, no allocation, no synchronisation.  The
// caller passes the scale (1/sqrt(D) rounded once to fp32, as the reference
// rounds it).  The entry points return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Sk, int H, int KV, int causal, float scale) {
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
  if (causal) {
    const int last_q = min(q0 + BQ, Sq) - 1;
    kv_end = min(Sk, offset + last_q + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
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
        if (kj >= Sk || (causal && qpos < kj)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
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
    T* row = o + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk, int H,
             int KV, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, bytes, stream>>>(q, k, v, o, Sq, Sk, H, KV, causal,
                                                     scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk, int H, int KV,
           int D, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                        int Sq, int Sk, int H, int KV, int D, int causal, float scale,
                        void* stream) {
  return launch<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<float*>(o), B, Sq, Sk, H,
                       KV, D, causal, scale, static_cast<cudaStream_t>(stream));
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                         int Sq, int Sk, int H, int KV, int D, int causal, float scale,
                        void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), static_cast<bf*>(o), B, Sq, Sk, H, KV, D,
                    causal, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
