// Fused MDS-encode matrix product for NVIDIA Hopper (sm_90a).
//
//   C_i = sum_j G[i,j] (A_j @ X)      G (n,k) fp32, A (k,M,K), X (K,N),
//                                     C (n,M,N) in A's dtype, fp32 accumulation
//
// Replaces the TPU kernel src/repro/kernels/coded_matmul/kernel.py::coded_matmul
// (Pallas body `_kernel`).  It computes the same function; the schedule is new.
//
// Design.  The TPU kernel encodes the k source tiles on chip and keeps an
// (n, bm, bn) fp32 accumulator in VMEM (0.8 MiB at n=12 and 128x128), far
// beyond the 227 KB of shared memory one Hopper block may use.  The product
// is linear, so the encode moves to the output side:
//   phase 1  P_s,j = A_j @ X over slice s of the K range, for every source
//            block j: k/n of the multiply-adds of encode-first, one fp32
//            partial row per (j, m) row of the (k*M) x K source, which is
//            read exactly once, and a grid whose parallelism does not shrink
//            as k grows;
//   phase 2  C_i = sum_j G[i,j] sum_s P_s,j in fp32, cast once to the output
//            dtype; where M*N fills the card, each thread reads its S*k
//            partials once and writes up to 16 coded outputs from registers,
//            else one coded output a thread.
// P is (S, k, M, N) fp32 scratch that the caller allocates, S the number of
// K slices.  With N << K it is a small fraction of A's bytes (S x 6.3 MB
// against 402.7 MB at 12288 x 8192 with N = 128), and neither the encoded
// operand nor an n-wide accumulator exists.
//
// Bound (published H100 SXM peaks at its 700 W limit).  At the paper-matvec
// shape (A 12288 x 8192 fp32) with N = 1 the job is a memory-bound
// matrix-vector product: 402.7 MB of A at 3.35 TB/s take ~120 us.  Phase 1 is
// then a warp-per-row GEMV with 16-byte loads (N <= 8, one K slice).  At
// N = 128 the 2*M*K*N = 25.8 GFLOP take ~0.39 ms at 67 TFLOP/s of fp32
// outside the tensor cores, so phase 1 is a register-tiled SIMT GEMM, and the
// issue slots go to FMA: a 128 x 128 output tile per block of 256 threads,
// an 8 x 8 micro-tile per thread (64 FMA for every four 16-byte
// shared-memory reads), 16-deep slices of A and X double-buffered in shared
// memory by cp.async, each thread's copy pointers set once per block so a
// slice costs four copies and a barrier against 1024 FMA.  Raw bf16 is
// copied and converted when read into registers.  A's tile stays row-major
// as copied, and a thread reads four consecutive k of a row as one 16-byte
// load, so neither operand needs a transposing store.  The micro-tile and
// A's four-k fragment take ~170 registers: one block per SM, no spills.  At
// the paper-matvec shape the output is only 96 such tiles for 132 SMs, so
// the K range is split into S slices (ops.split_count: at least two blocks
// per SM, the SMs level to 90 %; S = 4 there), each a multiple of 16 deep
// but the last.  Both phases accumulate in full fp32 with FMA: no TF32,
// whose 10-bit mantissa would break the fp32 tolerance of 1e-5.  Every edge
// is masked, so M, N and K need not tile (a ragged K or N, or an unaligned
// row, takes element copies instead of cp.async), and N = 1, k = 1 (G a
// column) and k = n (G = I) all work.
//
// Launch: on the caller's stream, no allocation, no synchronisation.  The
// entry points return cudaGetLastError() after the last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSkinnyN = 8;  // N <= kSkinnyN takes the GEMV schedule

// GEMM tile: BM x BN outputs per block, BK deep, TM x TN per thread (its
// columns in two groups of four, BN / 2 apart).  ops.py mirrors BM, BN, BK.
constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8;
static_assert((BM / TM) * (BN / TN) == kThreads, "one micro-tile per thread");
constexpr int AK = 4;            // k per read of a source row from shared memory
constexpr int kEncodeTile = 16;  // coded outputs a thread of encode_partials writes
constexpr int kEncodeBlocks = 2 * 132;  // ... when M*N alone fills this many blocks

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements of a row as floats; VEC > 1 reads 16 aligned bytes.
template <typename T, int VEC> struct Vec;

template <> struct Vec<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* out) { out[0] = *p; }
};

template <> struct Vec<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};


template <int VEC> struct Vec<__nv_bfloat16, VEC> {  // VEC = 2, 4 or 8
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    using Raw = typename std::conditional<VEC == 8, uint4,
                typename std::conditional<VEC == 4, uint2, uint32_t>::type>::type;
    const Raw v = *reinterpret_cast<const Raw*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <> struct Vec<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    out[0] = __bfloat162float(*p);
  }
};

// Phase 1, N <= kSkinnyN: one warp per row of the (rows x K) source.  Lanes
// stride the row in VEC-element pieces, keep one fp32 sum per column of X,
// and reduce across the warp with shuffles.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
partial_gemv(const T* __restrict__ A, const T* __restrict__ X,
             float* __restrict__ P, long long rows, int K, int N) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* a = A + row * K;
  float acc[kSkinnyN];
#pragma unroll
  for (int c = 0; c < kSkinnyN; ++c) acc[c] = 0.f;

  const int kvec = (K / VEC) * VEC;
#pragma unroll 4
  for (int kk = lane * VEC; kk < kvec; kk += 32 * VEC) {
    float av[VEC];
    Vec<T, VEC>::load(a + kk, av);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const T* x = X + (long long)(kk + v) * N;
#pragma unroll
      for (int c = 0; c < kSkinnyN; ++c)
        if (c < N) acc[c] = fmaf(av[v], to_f(x[c]), acc[c]);
    }
  }
  for (int kk = kvec + lane; kk < K; kk += 32) {  // ragged tail of the row
    const float av = to_f(a[kk]);
    const T* x = X + (long long)kk * N;
#pragma unroll
    for (int c = 0; c < kSkinnyN; ++c)
      if (c < N) acc[c] = fmaf(av, to_f(x[c]), acc[c]);
  }

#pragma unroll
  for (int c = 0; c < kSkinnyN; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kSkinnyN; ++c)
      if (c < N) P[row * N + c] = acc[c];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// First k of slice s of [0, K): the ceil(K / BK) slices of BK split as
// evenly as whole slices allow (ops.split_ranges mirrors it).
__device__ __forceinline__ int split_begin(int s, int splits, int K) {
  const long long nblk = (K + BK - 1) / BK;
  return (int)(s * nblk / splits) * BK;
}

// Phase 1, N > kSkinnyN: a BM x BN output tile of P[s] per block over the K
// slice s = blockIdx.z.  BK-deep slices of the source (row-major, BM x BK)
// and of X (BK x BN) are double-buffered in shared memory, in the inputs'
// dtype, zero past every edge.  VEC: 16-byte cp.async copies (rows of A and
// X 16-byte aligned, K and N multiples of 16 bytes); else element copies.
// Thread (ty, tx) owns rows ty + 16i (i < 8) and columns 4tx..4tx+3 and
// BN/2 + 4tx..BN/2 + 4tx+3: it reads A as one 16-byte float4 per row per
// four k (a warp's two ty read neighbouring rows, in other banks) and X as
// two float4 per k, each broadcast within a half-warp.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
partial_gemm(const T* __restrict__ A, const T* __restrict__ X,
             float* __restrict__ P, long long rows, int K, int N) {
  constexpr int EV = 16 / sizeof(T);  // elements per 16-byte copy
  __shared__ __align__(16) T As[2][BM * BK];
  __shared__ __align__(16) T Xs[2][BK * BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int s = blockIdx.z, splits = gridDim.z;
  const int kb = split_begin(s, splits, K);
  const int ke = s + 1 == splits ? K : split_begin(s + 1, splits, K);
  float* __restrict__ Ps = P + (long long)s * rows * N;

  // This thread's 16-byte copies (VEC): chunk c = tid + u * kThreads of each
  // tile, the same k offset in every A chunk and the same columns in every
  // X chunk, so the pointers are set once and step by BK rows of k a tile.
  constexpr int UA = BM * BK / EV / kThreads, UX = BK * BN / EV / kThreads;
  static_assert(UA * EV * kThreads == BM * BK && UX * EV * kThreads == BK * BN,
                "whole rounds of 16-byte copies");
  const int a_k = tid % (BK / EV) * EV, x_c = tid % (BN / EV) * EV;
  const T* a_src[UA];
  bool a_ok[UA];
#pragma unroll
  for (int u = 0; u < UA; ++u) {
    const int r = (tid + u * kThreads) / (BK / EV);
    a_ok[u] = row0 + r < rows;
    a_src[u] = A + (a_ok[u] ? (row0 + r) * K + kb + a_k : 0);
  }
  const bool x_ok = col0 + x_c < N;
  const T* x_src = X + (x_ok ? (long long)(kb + tid / (BN / EV)) * N + col0 + x_c : 0);
  constexpr int x_step = kThreads / (BN / EV);  // k rows between a thread's X chunks

  auto load = [&](int buf, int t) {  // tile t of the slice: k0 = kb + t * BK
    const int k0 = kb + t * BK;
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < UA; ++u) {
        const bool ok = a_ok[u] && k0 + a_k < ke;
        cp_async16(&As[buf][(tid + u * kThreads) * EV], ok ? a_src[u] + t * BK : A, ok);
      }
#pragma unroll
      for (int u = 0; u < UX; ++u) {
        const int kk = tid / (BN / EV) + u * x_step;
        const bool ok = x_ok && k0 + kk < ke;
        cp_async16(&Xs[buf][(tid + u * kThreads) * EV],
                   ok ? x_src + (long long)(t * BK + u * x_step) * N : X, ok);
      }
    } else {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const bool ok = row0 + r < rows && k0 + kk < ke;
        As[buf][e] = ok ? A[(row0 + r) * K + k0 + kk] : from_f<T>(0.f);
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int kk = e / BN, cc = e % BN;
        const bool ok = k0 + kk < ke && col0 + cc < N;
        Xs[buf][e] = ok ? X[(long long)(k0 + kk) * N + col0 + cc] : from_f<T>(0.f);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (ke - kb + BK - 1) / BK;
  load(0, 0);
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load(buf ^ 1, t + 1);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const T* as = As[buf] + ty * BK;
    const T* xs = Xs[buf] + tx * 4;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += AK) {
      float a[TM][AK];
#pragma unroll
      for (int i = 0; i < TM; ++i) Vec<T, AK>::load(as + i * (BM / TM) * BK + k0, a[i]);
#pragma unroll
      for (int kk = 0; kk < AK; ++kk) {
        float x[TN];
        Vec<T, 4>::load(xs + (k0 + kk) * BN, x);
        Vec<T, 4>::load(xs + (k0 + kk) * BN + BN / 2, x + 4);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], x[j], acc[i][j]);
      }
    }
    __syncthreads();  // this buffer is read; the next round refills it
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + i * (BM / TM);
    if (r >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = col0 + half * (BN / 2) + tx * 4;
      float* out = Ps + r * N + c;
      if constexpr (VEC) {  // N is a multiple of 4: the four columns are in or out together
        const float* v = acc[i] + 4 * half;
        if (c < N) *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) out[j] = acc[i][4 * half + j];
      }
    }
  }
}

// Phase 2: C[i] = sum_j G[i,j] sum_s P[s,j] at one of the M*N positions per
// thread, in fp32, one cast to the output dtype, for the OUTS coded outputs
// i of group blockIdx.y.  OUTS = kEncodeTile reads P once for n <= OUTS;
// OUTS = 1 spreads a small M*N over n times the threads.
template <typename T, int OUTS>
__global__ void __launch_bounds__(kThreads)
encode_partials(const float* __restrict__ G, const float* __restrict__ P,
                T* __restrict__ C, int n, int k, int splits, long long mn) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= mn) return;
  const long long plane = (long long)k * mn;  // one K slice of P
  const int i0 = blockIdx.y * OUTS;
  float acc[OUTS];
#pragma unroll
  for (int u = 0; u < OUTS; ++u) acc[u] = 0.f;
  for (int j = 0; j < k; ++j) {
    float p = 0.f;
    for (int s = 0; s < splits; ++s) p += P[s * plane + (long long)j * mn + idx];
#pragma unroll
    for (int u = 0; u < OUTS; ++u)
      if (i0 + u < n) acc[u] = fmaf(__ldg(G + (long long)(i0 + u) * k + j), p, acc[u]);
  }
#pragma unroll
  for (int u = 0; u < OUTS; ++u)
    if (i0 + u < n) C[(long long)(i0 + u) * mn + idx] = from_f<T>(acc[u]);
}

template <typename T>
int launch(const void* G, const void* A, const void* X, void* C, void* P,
           int n, int k, int M, int K, int N, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  const T* x = static_cast<const T*>(X);
  float* p = static_cast<float*>(P);
  const long long rows = (long long)k * M;
  constexpr int EV = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(A) % 16 == 0 && K % EV == 0;

  if (N <= kSkinnyN) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
    if (aligned)
      partial_gemv<T, EV><<<blocks, kThreads, 0, s>>>(a, x, p, rows, K, N);
    else
      partial_gemv<T, 1><<<blocks, kThreads, 0, s>>>(a, x, p, rows, K, N);
  } else {
    if (splits < 1 || splits > (K + BK - 1) / BK || splits > 65535)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                    (unsigned)splits);
    if (aligned && reinterpret_cast<uintptr_t>(X) % 16 == 0 && N % EV == 0)
      partial_gemm<T, true><<<grid, kThreads, 0, s>>>(a, x, p, rows, K, N);
    else
      partial_gemm<T, false><<<grid, kThreads, 0, s>>>(a, x, p, rows, K, N);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long mn = (long long)M * N;
  const unsigned blocks = (unsigned)((mn + kThreads - 1) / kThreads);
  const float* g = static_cast<const float*>(G);
  if (blocks >= kEncodeBlocks)
    encode_partials<T, kEncodeTile>
        <<<dim3(blocks, (n + kEncodeTile - 1) / kEncodeTile), kThreads, 0, s>>>(
            g, p, static_cast<T*>(C), n, k, splits, mn);
  else
    encode_partials<T, 1><<<dim3(blocks, n), kThreads, 0, s>>>(g, p, static_cast<T*>(C), n,
                                                               k, splits, mn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coded_matmul_f32(const void* G, const void* A, const void* X, void* C,
                                void* P, int n, int k, int M, int K, int N, int splits,
                                void* stream) {
  return launch<float>(G, A, X, C, P, n, k, M, K, N, splits, stream);
}

extern "C" int coded_matmul_bf16(const void* G, const void* A, const void* X, void* C,
                                 void* P, int n, int k, int M, int K, int N, int splits,
                                 void* stream) {
  return launch<__nv_bfloat16>(G, A, X, C, P, n, k, M, K, N, splits, stream);
}
