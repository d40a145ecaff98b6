// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t h_t,   h_0 = 0
//
//   x (B,S,H,P) and B, C (B,S,N) in one dtype (fp32 or bf16; B and C shared
//   over heads), dt (B,S,H) and A (H,) fp32, y (B,S,H,P) in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan
// (Pallas body `_kernel`), which computes the chunked form of
// models/mamba2.py::ssd_chunked.  Per chunk of Q steps, with lcum the
// inclusive cumulative sum of dt*A inside the chunk:
//   y_t  = sum_{s<=t} (C_t . B_s) exp(lcum_t - lcum_s) dt_s x_s
//          + exp(lcum_t) (C_t h^T)
//   h   <- h exp(lcum_{Q-1}) + sum_s x_s^T (B_s exp(lcum_{Q-1} - lcum_s) dt_s)
//
// Design.  One block of 256 threads per (head, batch row).  The Pallas grid's
// sequential chunk axis becomes a loop inside the block, and the fp32 state
// h (P x N: 32 KB at P = 64, N = 128) stays in shared memory across chunks.
// The Pallas kernel builds the (Q x Q) decay, C B^T and weight matrices of a
// chunk whole; at Q = 256 each is 256 KB of fp32, more than a Hopper block
// may hold (227 KB).  Here the intra-chunk term is tiled: 64 rows t at a
// time, and for each, 64 source steps s at a time up to the diagonal; the
// 64 x 64 weight tile (C_t . B_s) exp(lcum_t - lcum_s) dt_s goes through
// shared memory into y's registers.  The decay is always the exponential
// of a difference: A lies in [-16, -1), so lcum over one chunk falls far
// below -88, where exp(lcum) underflows, and exp(lcum_t) / exp(lcum_s)
// would be 0/0.  lcum is a warp scan.  Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows 4ty..4ty+3 and columns tx + 16j of the y tile and of the weight
// tile, so the weights a thread needs are written by its own warp.  The state
// update gives thread tid the entries p = tid % P, n = tid / P + k 256/P of h.
//
// Bound (published H100 SXM peaks at its 700 W limit).  At mamba2-1.3b
// prefill (B 2, S 4096, H 64, P 64, N 128, Q 256, bf16 x) the chunked form
// needs ~26 GFLOP (C B^T over the causal half once per batch row and chunk,
// then per head the causal half of the weighted sum, C h^T and the state
// update) against ~140 MB of x, dt, B, C and y: ~0.39 ms at the 67 TFLOP/s
// of fp32 outside the tensor cores, so it is bound by operations.  This
// first design recomputes C B^T for every head (H times the needed work of
// that term), does all products as fp32 FMA, and runs B*H blocks (128 at
// batch 2), which do not fill the 132 SMs at one block each; both are later
// work.
//
// Launch: on the caller's stream, no allocation, no synchronisation.  The
// entry points return cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int TQ = 64;        // rows t (and source steps s) per tile
constexpr int kMaxState = 32; // h entries per thread: P * N <= 8192

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int P, int N, int Q) {
  const size_t ln = (size_t)N + 1;
  return sizeof(float) * ((size_t)P * ln + 2 * TQ * ln + (size_t)TQ * P +
                          (size_t)TQ * (TQ + 1) + 2 * (size_t)Q);
}

// rows [r0, r0 + TQ) of a (B,S,N) operand for batch row b, chunk start base,
// into dst (TQ x (N+1)); rows at or past Q are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int b,
                                          int S, int N, int base, int r0, int Q) {
  const int ln = N + 1;
  for (int i = threadIdx.x; i < TQ * N; i += kThreads) {
    const int r = i / N, n = i % N;
    const int t = r0 + r;
    dst[r * ln + n] = t < Q ? to_f(src[((size_t)b * S + base + t) * N + n]) : 0.f;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int S, int H, int N, int Q) {
  static_assert(P % 16 == 0 && kThreads % P == 0, "head dim P in {16, 32, 64}");
  constexpr int NJ = P / 16;            // y columns per thread
  constexpr int NSTEP = kThreads / P;   // stride of a thread's state columns
  const int ln = N + 1;
  extern __shared__ float smem[];
  float* hs = smem;                     // P x ln   state h, fp32
  float* Cs = hs + P * ln;              // TQ x ln  C rows of the t tile
  float* Bs = Cs + TQ * ln;             // TQ x ln  B rows of the s tile
  float* xs = Bs + TQ * ln;             // TQ x P   x rows of the s tile
  float* Ws = xs + TQ * P;              // TQ x (TQ+1) weights of the tile
  float* lc = Ws + TQ * (TQ + 1);       // Q        lcum of the chunk
  float* dts = lc + Q;                  // Q        dt of the chunk

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float a = A[h];
  const int sp = tid % P;               // this thread's state row p
  const int sn0 = tid / P;              // and first state column n

  for (int i = tid; i < P * ln; i += kThreads) hs[i] = 0.f;

  for (int base = 0; base < S; base += Q) {
    __syncthreads();  // h written, lc and dts of the last chunk no longer read
    for (int i = tid; i < Q; i += kThreads) dts[i] = dt[((size_t)b * S + base + i) * H + h];
    __syncthreads();
    if (tid < 32) {   // inclusive scan of dt * A: each lane a run, then lanes
      const int per = (Q + 31) / 32;
      const int lo = min(tid * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += dts[i] * a;
        lc[i] = run;
      }
      float total = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, total, off);
        if (tid >= off) total += o;
      }
      float before = __shfl_up_sync(0xffffffffu, total, 1);
      if (tid == 0) before = 0.f;
      for (int i = lo; i < hi; ++i) lc[i] += before;
    }

    // ---- y, one tile of TQ rows t at a time --------------------------------
    for (int t0 = 0; t0 < Q; t0 += TQ) {
      __syncthreads();  // lc ready; the last tile's Cs, Bs, xs no longer read
      load_rows(Cs, Cm, b, S, N, base, t0, Q);
      __syncthreads();

      float acc[4][NJ];
      // inter-chunk term: exp(lcum_t) (C_t h^T)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float c[4], hv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = Cs[(ty * 4 + i) * ln + n];
#pragma unroll
        for (int j = 0; j < NJ; ++j) hv[j] = hs[(tx + 16 * j) * ln + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(c[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        const float e = t < Q ? expf(lc[t]) : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= e;
      }

      // intra-chunk term, source tiles up to the diagonal
      for (int s0 = 0; s0 <= t0; s0 += TQ) {
        __syncthreads();  // the last source tile is no longer read
        load_rows(Bs, Bm, b, S, N, base, s0, Q);
        for (int i = tid; i < TQ * P; i += kThreads) {
          const int r = i / P, p = i % P;
          const int s = s0 + r;
          xs[i] = s < Q ? to_f(x[(((size_t)b * S + base + s) * H + h) * P + p]) : 0.f;
        }
        __syncthreads();

        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float c[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = Cs[(ty * 4 + i) * ln + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = Bs[(tx + 16 * j) * ln + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) w[i][j] = fmaf(c[i], bb[j], w[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float val = 0.f;
            if (t < Q && s <= t) val = w[i][j] * expf(lc[t] - lc[s]) * dts[s];
            Ws[(ty * 4 + i) * (TQ + 1) + tx + 16 * j] = val;
          }
        }
        __syncwarp();  // a thread's weight rows are written by its own warp

#pragma unroll 4
        for (int s = 0; s < TQ; ++s) {
          float wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty * 4 + i) * (TQ + 1) + s];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float xv = xs[s * P + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wv[i], xv, acc[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        if (t >= Q) continue;
        T* row = y + (((size_t)b * S + base + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
      }
    }

    // ---- state update -----------------------------------------------------
    const float last = lc[Q - 1];
    float hacc[kMaxState];
#pragma unroll
    for (int k = 0; k < kMaxState; ++k) hacc[k] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += TQ) {
      __syncthreads();  // the y tiles' Bs and xs are no longer read
      for (int i = tid; i < TQ * N; i += kThreads) {
        const int r = i / N, n = i % N;
        const int s = s0 + r;
        float val = 0.f;
        if (s < Q)
          val = to_f(Bm[((size_t)b * S + base + s) * N + n]) * (expf(last - lc[s]) * dts[s]);
        Bs[r * ln + n] = val;
      }
      for (int i = tid; i < TQ * P; i += kThreads) {
        const int r = i / P, p = i % P;
        const int s = s0 + r;
        xs[i] = s < Q ? to_f(x[(((size_t)b * S + base + s) * H + h) * P + p]) : 0.f;
      }
      __syncthreads();
      const int rows = min(TQ, Q - s0);
      for (int s = 0; s < rows; ++s) {
        const float xv = xs[s * P + sp];
#pragma unroll
        for (int k = 0; k < kMaxState; ++k) {
          const int n = sn0 + k * NSTEP;
          if (n < N) hacc[k] = fmaf(xv, Bs[s * ln + n], hacc[k]);
        }
      }
    }
    __syncthreads();  // every thread's last read of h (the y tiles) is done
    const float decay = expf(last);
#pragma unroll
    for (int k = 0; k < kMaxState; ++k) {
      const int n = sn0 + k * NSTEP;
      if (n < N) hs[sp * ln + n] = hs[sp * ln + n] * decay + hacc[k];
    }
  }
}

template <typename T, int P>
int launch_p(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm, T* y,
             int B, int S, int H, int N, int Q, cudaStream_t stream) {
  if (P * N > kMaxState * kThreads) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(P, N, Q);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  ssd_scan_kernel<T, P><<<grid, kThreads, bytes, stream>>>(x, dt, A, Bm, Cm, y, S, H, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm, T* y,
           int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || N < 1 || Q < 1 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 16: return launch_p<T, 16>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, stream);
    case 32: return launch_p<T, 32>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, stream);
    case 64: return launch_p<T, 64>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, int B, int S, int H, int P, int N, int Q,
                 void* stream) {
  return launch<float>(static_cast<const float*>(x), static_cast<const float*>(dt),
                       static_cast<const float*>(A), static_cast<const float*>(Bm),
                       static_cast<const float*>(Cm), static_cast<float*>(y), B, S, H, P,
                       N, Q, static_cast<cudaStream_t>(stream));
}

int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                  const void* Cm, void* y, int B, int S, int H, int P, int N, int Q,
                  void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(static_cast<const bf*>(x), static_cast<const float*>(dt),
                    static_cast<const float*>(A), static_cast<const bf*>(Bm),
                    static_cast<const bf*>(Cm), static_cast<bf*>(y), B, S, H, P, N, Q,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
