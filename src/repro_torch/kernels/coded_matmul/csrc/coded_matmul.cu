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
//   phase 1  P_j = A_j @ X for every source block j: k/n of the multiply-adds
//            of encode-first, one fp32 partial row per (j, m) row of the
//            (k*M) x K source, which is read exactly once, and a grid whose
//            parallelism does not shrink as k grows;
//   phase 2  C_i = sum_j G[i,j] P_j in fp32, cast once to the output dtype.
// P is (k, M, N) fp32 scratch that the caller allocates.  With N << K it is a
// small fraction of A's bytes (6.3 MB against 402.7 MB at 12288 x 8192 with
// N = 128), and neither the encoded operand nor an n-wide accumulator exists.
//
// Bound (published H100 SXM peaks at its 700 W limit).  At the paper-matvec
// shape (A 12288 x 8192 fp32) with N = 1 the job is a memory-bound
// matrix-vector product: 402.7 MB of A at 3.35 TB/s take ~120 us.  Phase 1 is
// then a warp-per-row GEMV with 16-byte loads.  At N = 128 the 2*M*K*N =
// 25.8 GFLOP take ~0.39 ms at 67 TFLOP/s of non-tensor fp32, so phase 1 is a
// shared-memory-tiled SIMT GEMM with 4x4 register micro-tiles.  Both phases
// accumulate in full fp32 with FMA: no TF32, whose 10-bit mantissa would
// break the fp32 tolerance of 1e-5.  Every edge is masked, so M, N and K
// need not tile, and N = 1, k = 1 (G a column) and k = n (G = I) all work.
//
// Launch: on the caller's stream, no allocation, no synchronisation.  The
// entry points return cudaGetLastError() after the last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSkinnyN = 8;  // N <= kSkinnyN takes the GEMV schedule

// GEMM tile: BM x BN outputs per block, BK deep, TM x TN per thread.
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
static_assert((BM / TM) * (BN / TN) == kThreads, "one micro-tile per thread");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements of a row as floats; VEC > 1 reads 16 aligned bytes.
template <typename T, int VEC> struct Vec;

template <typename T> struct Vec<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float* out) { out[0] = to_f(*p); }
};

template <> struct Vec<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <> struct Vec<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
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

// Phase 1, N > kSkinnyN: BM x BN output tile per block, BK-deep slices of the
// source and of X staged in shared memory as fp32 (zero-filled past every
// edge), a TM x TN register micro-tile per thread strided by 16 so that the
// shared-memory reads are broadcasts or conflict-free.
template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_gemm(const T* __restrict__ A, const T* __restrict__ X,
             float* __restrict__ P, long long rows, int K, int N) {
  __shared__ float As[BK][BM + 1];  // transposed; +1 spreads the stores over banks
  __shared__ float Xs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, kk = e % BK;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < rows && gk < K) ? to_f(A[gr * K + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Xs[kk][c] = (gk < K && gc < N) ? to_f(X[(long long)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], x[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) x[j] = Xs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + i * (BM / TM);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * (BN / TN);
      if (c < N) P[r * N + c] = acc[i][j];
    }
  }
}

// Phase 2: C[i] = sum_j G[i,j] P[j] over the M*N outputs of coded task i
// (blockIdx.y), in fp32, one cast to the output dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_partials(const float* __restrict__ G, const float* __restrict__ P,
                T* __restrict__ C, int k, long long mn) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= mn) return;
  const int i = blockIdx.y;
  const float* g = G + (long long)i * k;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) acc = fmaf(g[j], P[(long long)j * mn + idx], acc);
  C[(long long)i * mn + idx] = from_f<T>(acc);
}

template <typename T>
int launch(const void* G, const void* A, const void* X, void* C, void* P,
           int n, int k, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  const T* x = static_cast<const T*>(X);
  float* p = static_cast<float*>(P);
  const long long rows = (long long)k * M;

  if (N <= kSkinnyN) {
    constexpr int VEC = 16 / sizeof(T);
    const bool aligned = reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                         ((long long)K * sizeof(T)) % 16 == 0;
    const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
    if (aligned)
      partial_gemv<T, VEC><<<blocks, kThreads, 0, s>>>(a, x, p, rows, K, N);
    else
      partial_gemv<T, 1><<<blocks, kThreads, 0, s>>>(a, x, p, rows, K, N);
  } else {
    const dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
    partial_gemm<T><<<grid, kThreads, 0, s>>>(a, x, p, rows, K, N);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long mn = (long long)M * N;
  const dim3 grid((unsigned)((mn + kThreads - 1) / kThreads), (unsigned)n);
  encode_partials<T><<<grid, kThreads, 0, s>>>(static_cast<const float*>(G), p,
                                               static_cast<T*>(C), k, mn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coded_matmul_f32(const void* G, const void* A, const void* X, void* C,
                                void* P, int n, int k, int M, int K, int N, void* stream) {
  return launch<float>(G, A, X, C, P, n, k, M, K, N, stream);
}

extern "C" int coded_matmul_bf16(const void* G, const void* A, const void* X, void* C,
                                 void* P, int n, int k, int M, int K, int N, void* stream) {
  return launch<__nv_bfloat16>(G, A, X, C, P, n, k, M, K, N, stream);
}
