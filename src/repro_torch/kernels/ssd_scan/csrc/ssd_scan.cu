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
// Every decay is the exponential of a difference: A lies in [-16, -1), so
// lcum over one chunk falls far below -88, where exp(lcum) underflows, and
// exp(lcum_t) / exp(lcum_s) would be 0/0.
//
// Bound (published H100 SXM peaks at its 700 W limit).  At mamba2-1.3b
// prefill (B 2, S 4096, H 64, P 64, N 128, Q 256, bf16 x, B and C) the
// chunked form needs 26.1 GFLOP (C B^T over the causal half once per batch
// row and chunk; per head the causal half of the weighted sum, C h^T and the
// chunk's state): 0.026 ms at the 989 TFLOP/s of bf16 tensor cores.  It
// moves ~140.5 MB (x and y 67.1 MB each, dt 2.1 MB, B and C 2.1 MB each):
// 0.042 ms at 3.35 TB/s.  So the bf16 scan is bound by bytes.
//
// bf16: the tensor-core schedule (namespace tc), four kernels a call.  The
// TPU kernel walks the chunks in order on one core, and the first port
// copied that walk into one block per (head, batch row), 128 blocks for 132
// SMs.  Here only the state passing is sequential; the rest runs parallel
// over (batch, chunk, head), and every product is an mma.sync.m16n8k16 in
// bf16 with fp32 accumulation.  With l2 = lcum log2(e), every decay is one
// ex2 of a difference:
//   1. ssd_scan_cb, per (64-row tile, chunk, batch): G = C B^T over the
//      causal 16 x 16 tiles, once per chunk and not once per head, into an
//      fp32 workspace (B, nc, Qp, Qp), Qp = Q rounded up to 16.
//   2. ssd_scan_state, per (head, chunk, batch): a block scan of dt A into
//      (l2, dt) pairs (workspace (B, nc, H, Qp); x and B already loading),
//      then the chunk's own state s_c = (x w)^T B, w_s = 2^(l2_{Q-1} - l2_s)
//      dt_s, a (P x Q)(Q x N) product, into an fp32 workspace (B, nc, H, P,
//      N).
//   3. ssd_scan_pass, per (P*N slice, head, batch): the one sequential step,
//      elementwise in fp32, h_c = h_{c-1} 2^(l2_{Q-1}) + s_c, four chunks'
//      loads in flight; in place it turns each s_c into the state entering
//      chunk c, stored as the two bf16 parts the next kernel multiplies.
//   4. ssd_scan_out, per (64-row tile, head, batch x chunk): y = 2^(l2_t)
//      (C h^T) + W x, W = G o 2^(l2_t - l2_s) o dt_s on and below the
//      diagonal; nothing above it is read or computed, and the masks run
//      only on diagonal and ragged tiles.  One two-stage ring carries first
//      the column blocks of C and h, then the step blocks of G, x and (l2,
//      dt) up to the diagonal; y leaves through shared memory as 16-byte
//      row stores.
// Tiles arrive by 16-byte cp.async, zero-filled past Q, N and Qp, so Q < 16,
// N = 8 or 40 and P = 16 need no other case; bf16 operands reach the tensor
// cores by ldmatrix from padded rows, fp32 G by float2 reads from rows whose
// 16-byte chunks are swizzled, both free of bank conflicts.  The fp32
// operands of the products (W, the carried state h and x w) go to the
// tensor cores as two bf16 parts, hi = bf16(v) and lo = bf16(v - hi), which
// carry 2^-17 of v: rounded once they carry 2^-9, and a CPU emulation of
// this schedule (tests/test_torch_ssd_scan.py) reads more than half the
// card's limit of 1e-2 of max|y| on reference-grid inputs with any one of
// them rounded once, and under a third of it with all three split.  The
// state is accumulated, carried and passed in fp32.  What this leaves
// against the bound: the chunk states make a round trip through device
// memory (written, read and written by the pass, read again: ~270 MB at the
// main shape, twice the bound's bytes), x is read twice (steps 2 and 4),
// each head's blocks read G, C and x again from L2, the hi + lo split
// doubles the tensor work of the per-head products, and each block waits on
// its own ring with four blocks an SM: no warp specialisation, persistent
// blocks, TMA or wgmma.
//
// fp32: the SIMT schedule (namespace simt), unchanged since the port.  One
// block of 256 threads per (head, batch row) walks the chunks in order, the
// fp32 state h (P x N) in shared memory; the intra-chunk term is tiled 64
// rows t by 64 steps s, and every product is fp32 FMA on the CUDA cores,
// which keeps the fp32 tolerance of 2e-5 of max|y|.  lcum is a warp scan.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4ty..4ty+3 and columns
// tx + 16j of the y tile and of the weight tile, so the weights a thread
// needs are written by its own warp.  The state update gives thread tid the
// entries p = tid % P, n = tid / P + k 256/P of h.
//
// Launch: on the caller's stream, no allocation, no synchronisation (the
// bf16 workspace comes from the caller: ssd_scan_bf16_workspace bytes).  The
// entry points return cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape the kernels do not take: the fp32
// schedule a state or chunk that does not fit one block; the bf16 schedule
// N not a multiple of 8, P * N > 8192, or an operand not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ===========================================================================
// fp32: the SIMT schedule
// ===========================================================================
namespace simt {


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

int launch_f32(const float* x, const float* dt, const float* A, const float* Bm,
               const float* Cm, float* y, int B, int S, int H, int P, int N, int Q,
               cudaStream_t stream) {
  switch (P) {
    case 16: return launch_p<float, 16>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, stream);
    case 32: return launch_p<float, 32>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, stream);
    case 64: return launch_p<float, 64>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ===========================================================================
// bf16: the tensor-core schedule
// ===========================================================================
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;      // rows t of a tile, steps s of a staged block
constexpr int kMaxPN = 8192;   // P * N
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes from global to shared memory, the bytes past `src_bytes` zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each matrix, row l / 4, columns 2 (l % 4) + {0, 1}
// (.trans: column l / 4, rows 2 (l % 4) + {0, 1})
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// d (16 x 8 fp32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col).  With g =
// lane / 4 and q = lane % 4: a[0] holds (row g, cols 2q, 2q+1), a[1] row g+8,
// a[2] and a[3] the same rows at cols + 8; b0 (rows 2q, 2q+1, col g), b1 rows
// + 8; d[0..1] (row g, cols 2q, 2q+1), d[2..3] row g+8.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
// (u, v) as two bf16 pairs: hi = bf16(.), lo = bf16(. - hi)
__device__ __forceinline__ void split(float u, float v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}
__device__ __forceinline__ float bf_at(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ex2(float v) {  // 2^v, 2^-22 relative
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// A fragment rows (row0 + (l % 8) + 8 ((l / 8) % 2)), column k0 + 8 (l / 16);
// B^T rows (n) n0 + (l % 8) + 8 (l / 16), column k0 + 8 ((l / 8) % 2); B
// rows (k) k0 + (l % 8) + 8 ((l / 8) % 2), column n0 + 8 (l / 16), .trans
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + 8 * ((lane >> 3) & 1); }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane >> 4); }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + 8 * (lane >> 4); }
__device__ __forceinline__ int bt_col(int lane) { return 8 * ((lane >> 3) & 1); }

// rows [0, kRows) of a bf16 matrix whose row r starts at src + r * ld (cols
// elements, a multiple of 8) into dst (row stride lds), zero past row
// `valid` and past column `cols` up to `cols16`
__device__ __forceinline__ void load_rows(bf16* dst, int lds, const bf16* src, long long ld,
                                          int valid, int cols, int cols16, int tid,
                                          int nthreads) {
  const int per_row = cols16 / 8;
  for (int i = tid; i < kRows * per_row; i += nthreads) {
    const int r = i / per_row, ch = i % per_row;
    const bool ok = r < valid && ch * 8 < cols;
    cp_async16(dst + r * lds + ch * 8, ok ? src + r * ld + ch * 8 : src, ok ? 16 : 0);
  }
}

// 1. G = C B^T over the causal 16 x 16 tiles of a 64-row tile of a chunk
__global__ void __launch_bounds__(128)
ssd_scan_cb(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, float* __restrict__ G,
            int S, int N, int Q, int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N16 = round16(N), ld = N16 + 8, Qp = round16(Q);
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // kRows x ld: C rows of the tile
  bf16* Bs = Cs + kRows * ld;                // kRows x ld: B rows of a block
  const int t0 = blockIdx.x * kRows, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  float* Gc = G + ((size_t)b * nc + c) * Qp * Qp;
  const int r0 = t0 + 16 * w;  // this warp's rows, r0..r0+15
  load_rows(Cs, ld, Cm + (row0 + t0) * N, N, Q - t0, N, N16, tid, 128);
  for (int sb = 0; sb <= t0; sb += kRows) {
    __syncthreads();  // the last block's B rows are no longer read
    load_rows(Bs, ld, Bm + (row0 + sb) * N, N, Q - sb, N, N16, tid, 128);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (r0 >= Qp) continue;
    for (int j = 0; j < kRows / 16 && sb + 16 * j <= r0; ++j) {
      float acc[2][4] = {};
      for (int k = 0; k < N16; k += 16) {
        uint32_t a[4], bt[4];
        ldsm_x4(a, Cs + (16 * w + a_row(lane)) * ld + k + a_col(lane));
        ldsm_x4(bt, Bs + (16 * j + bt_row(lane)) * ld + k + bt_col(lane));
        mma(acc[0], a, bt[0], bt[1]);
        mma(acc[1], a, bt[2], bt[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* dst = Gc + (size_t)(r0 + g) * Qp + sb + 16 * j + 8 * nt + 2 * q;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(dst + 8 * (size_t)Qp) = make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// 2. lcum of the chunk, then its own state s_c = (x w)^T B
template <int P>
__global__ void __launch_bounds__(256, 3)
ssd_scan_state(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm, float2* L,
               float* __restrict__ St, int S, int H, int N, int Q, int nc) {
  constexpr int kT = 256, MT = P / 16, NGR = 8 / MT, LDX = P + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N16 = round16(N), ldb = N16 + 8, Qp = round16(Q);
  bf16* xs = reinterpret_cast<bf16*>(smem);                // 2 x kRows x LDX
  bf16* Bs = xs + 2 * kRows * LDX;                         // 2 x kRows x ldb
  float2* Ls = reinterpret_cast<float2*>(Bs + 2 * kRows * ldb);  // 2 x kRows (l2, dt)
  float* part = reinterpret_cast<float*>(Ls + 2 * kRows);  // 8 warp sums
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  const size_t bch = ((size_t)b * nc + c) * H + h;
  float2* Lc = L + bch * Qp;
  const float a = A[h];

  auto load_xb = [&](int buf, int sb) {
    load_rows(xs + buf * kRows * LDX, LDX, x + ((row0 + sb) * H + h) * P,
              (long long)H * P, Q - sb, P, P, tid, kT);
    load_rows(Bs + buf * kRows * ldb, ldb, Bm + (row0 + sb) * N, N, Q - sb, N, N16, tid,
              kT);
  };
  auto load_l = [&](int buf, int sb) {  // (l2, dt) of steps sb.., zero past Qp
    if (tid < kRows / 2) {
      const bool ok = sb + 2 * tid < Qp;
      cp_async16(Ls + buf * kRows + 2 * tid, ok ? Lc + sb + 2 * tid : Lc, ok ? 16 : 0);
    }
  };
  load_xb(0, 0);  // in flight during the scan
  cp_async_commit();

  // (l2, dt) of each step, l2 = lcum log2(e), kT steps a round; steps past Q
  // add nothing
  float carry = 0.f;
  for (int s0 = 0; s0 < Qp; s0 += kT) {
    const int s = s0 + tid;
    const float d = s < Q ? dt[(row0 + s) * H + h] : 0.f;
    float v = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    if (lane == 31) part[w] = v;
    __syncthreads();
    float before = carry, total = carry;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < w) before += part[i];
      total += part[i];
    }
    if (s < Qp) Lc[s] = make_float2((before + v) * kLog2e, d);
    carry = total;
    __syncthreads();  // part is read before the next round writes it
  }
  load_l(0, 0);
  cp_async_commit();
  const float last = Lc[Q - 1].x;

  // s_c: warp (mw, ng) owns state rows 16 mw.. and n-tile pairs [q0, q1)
  const int mw = w % MT, ng = w / MT;
  const int pairs = N16 / 16, per = (pairs + NGR - 1) / NGR;
  const int q0 = ng * per, q1 = min(pairs, q0 + per);
  float acc[8][4] = {};
  const int blocks = (Qp + kRows - 1) / kRows;
  for (int i = 0; i < blocks; ++i) {
    const int buf = i & 1, sb = i * kRows;
    if (i + 1 < blocks) {
      load_xb(buf ^ 1, sb + kRows);
      load_l(buf ^ 1, sb + kRows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xb = xs + buf * kRows * LDX;
    const bf16* bb = Bs + buf * kRows * ldb;
    const float2* lb = Ls + buf * kRows;
    const int steps = min(kRows, Qp - sb);
    for (int k = 0; k < steps; k += 16) {
      // A = (x w)^T: rows p = 16 mw + g (+8), columns s = k + 2q (+1, +8, +9),
      // w_s = 2^(l2_{Q-1} - l2_s) dt_s (0 past Q, where dt reads 0)
      const int s = k + 2 * q, p = 16 * mw + g;
      const float4 l01 = *reinterpret_cast<const float4*>(lb + s);
      const float4 l89 = *reinterpret_cast<const float4*>(lb + s + 8);
      const float w0 = ex2(last - l01.x) * l01.y, w1 = ex2(last - l01.z) * l01.w;
      const float w8 = ex2(last - l89.x) * l89.y, w9 = ex2(last - l89.z) * l89.w;
      const bf16* xr = xb + s * LDX + p;
      uint32_t hi[4], lo[4];
      split(bf_at(xr) * w0, bf_at(xr + LDX) * w1, hi[0], lo[0]);
      split(bf_at(xr + 8) * w0, bf_at(xr + LDX + 8) * w1, hi[1], lo[1]);
      split(bf_at(xr + 8 * LDX) * w8, bf_at(xr + 9 * LDX) * w9, hi[2], lo[2]);
      split(bf_at(xr + 8 * LDX + 8) * w8, bf_at(xr + 9 * LDX + 8) * w9, hi[3], lo[3]);
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        const int pr = q0 + i2;
        if (pr >= q1) break;
        uint32_t bk[4];
        ldsm_x4_t(bk, bb + (k + a_row(lane)) * ldb + 16 * pr + a_col(lane));
        mma(acc[2 * i2], hi, bk[0], bk[1]);
        mma(acc[2 * i2], lo, bk[0], bk[1]);
        mma(acc[2 * i2 + 1], hi, bk[2], bk[3]);
        mma(acc[2 * i2 + 1], lo, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this block's buffers are refilled next round
  }
  float* Sc = St + bch * P * N + (size_t)(16 * mw + g) * N;
#pragma unroll
  for (int i2 = 0; i2 < 8; ++i2) {
    const int n = 8 * (2 * q0 + i2) + 2 * q;
    if (2 * q0 + i2 >= 2 * q1 || n >= N) break;
    *reinterpret_cast<float2*>(Sc + n) = make_float2(acc[i2][0], acc[i2][1]);
    *reinterpret_cast<float2*>(Sc + 8 * N + n) = make_float2(acc[i2][2], acc[i2][3]);
  }
}

// 3. h_c = h_{c-1} 2^(l2_{Q-1}) + s_c in chunk order, in fp32.  In place, St[c]
// becomes h_{c-1} as two bf16 parts: each group of 8 entries (32 bytes)
// holds bf16(h) of the 8, then bf16(h - bf16(h)).
__global__ void __launch_bounds__(256)
ssd_scan_pass(float* __restrict__ St, const float2* __restrict__ L, int H, int PN, int Q,
              int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * 256 + threadIdx.x;  // group of 8 entries of a state
  const int Qp = round16(Q);
  if (8 * i >= PN) return;
  float run[8] = {};
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 v[4][2];
    float d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // four chunks' loads in flight at once
      if (c0 + j >= nc) break;
      const size_t bch = ((size_t)b * nc + c0 + j) * H + h;
      const float4* src = reinterpret_cast<const float4*>(St + bch * PN) + 2 * i;
      v[j][0] = src[0];
      v[j][1] = src[1];
      d[j] = exp2f(L[bch * Qp + Q - 1].x);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= nc) break;
      const size_t bch = ((size_t)b * nc + c0 + j) * H + h;
      uint4 hi, lo;
      split(run[0], run[1], hi.x, lo.x);
      split(run[2], run[3], hi.y, lo.y);
      split(run[4], run[5], hi.z, lo.z);
      split(run[6], run[7], hi.w, lo.w);
      uint4* dst = reinterpret_cast<uint4*>(St + bch * PN) + 2 * i;
      dst[0] = hi;
      dst[1] = lo;
      const float s_c[8] = {v[j][0].x, v[j][0].y, v[j][0].z, v[j][0].w,
                            v[j][1].x, v[j][1].y, v[j][1].z, v[j][1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) run[e] = fmaf(run[e], d[j], s_c[e]);
    }
  }
}

// bytes of one stage of ssd_scan_out's ring: the larger of a block of steps
// (G, x, (l2, dt)) and a block of columns (h hi, h lo, C)
template <int P>
__host__ __device__ constexpr int out_stage() {
  return kRows * kRows * 4 + kRows * (P + 8) * 2 + kRows * 8 > (2 * P + kRows) * (kRows + 8) * 2
             ? kRows * kRows * 4 + kRows * (P + 8) * 2 + kRows * 8
             : (2 * P + kRows) * (kRows + 8) * 2;
}

// A 64-column fp32 tile in shared memory, its 16-byte chunks swizzled by row:
// the float2 reads of an mma fragment (rows g, columns 2q + 16j) then hit 32
// distinct banks in each half warp.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRows + ((((c >> 2) ^ ((r & 3) << 1))) << 2) + (c & 3);
}
// rows [0, kRows) of an fp32 matrix whose row r starts at src + r * ld,
// columns [0, kRows), into a swizzled tile, zero past row `valid` and past
// column `cols` (a multiple of 4)
__device__ __forceinline__ void load_f32(float* dst, const float* src, long long ld,
                                         int valid, int cols, int tid) {
  for (int i = tid; i < kRows * (kRows / 4); i += 128) {
    const int r = i / (kRows / 4), c = 4 * (i % (kRows / 4));
    const bool ok = r < valid && c < cols;
    cp_async16(dst + swz(r, c), ok ? src + r * ld + c : src, ok ? 16 : 0);
  }
}

// W fragment (rows ta and tb = ta + 8, steps s..s+1 and s+8..s+9, s = col of
// the block) of G o 2^(l2_t - l2_s) o dt_s, as bf16 hi and lo parts; kMask
// zeroes the weights above the diagonal and on rows past Q
template <bool kMask>
__device__ __forceinline__ void weights(const float* gb, int r, int col, const float2* lsb,
                                        float la, float lb, int ta, int s, int Q,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 l0 = lsb[col], l1 = lsb[col + 1], l8 = lsb[col + 8], l9 = lsb[col + 9];
  const float2 g00 = *reinterpret_cast<const float2*>(gb + swz(r, col));
  const float2 g10 = *reinterpret_cast<const float2*>(gb + swz(r + 8, col));
  const float2 g01 = *reinterpret_cast<const float2*>(gb + swz(r, col + 8));
  const float2 g11 = *reinterpret_cast<const float2*>(gb + swz(r + 8, col + 8));
  const int tb = ta + 8;
  auto w = [&](float gv, float lt, int t, float2 ls, int ss) {
    const float v = gv * ex2(lt - ls.x) * ls.y;
    return kMask ? (ss <= t && t < Q ? v : 0.f) : v;
  };
  split(w(g00.x, la, ta, l0, s), w(g00.y, la, ta, l1, s + 1), hi[0], lo[0]);
  split(w(g10.x, lb, tb, l0, s), w(g10.y, lb, tb, l1, s + 1), hi[1], lo[1]);
  split(w(g01.x, la, ta, l8, s + 8), w(g01.y, la, ta, l9, s + 9), hi[2], lo[2]);
  split(w(g11.x, lb, tb, l8, s + 8), w(g11.y, lb, tb, l9, s + 9), hi[3], lo[3]);
}

// 4. y = 2^(l2_t) (C h^T) + W x for a 64-row tile of a chunk and one head.
// One loop over blocks of 64: first the N / 64 blocks of the inter-chunk
// term (C columns and h columns), then the blocks of 64 steps up to the
// diagonal (G, x, and (l2, dt)), all through one two-stage ring.
template <int P>
__global__ void __launch_bounds__(128)
ssd_scan_out(const bf16* __restrict__ x, const bf16* __restrict__ Cm,
             const float* __restrict__ G, const float2* __restrict__ L,
             const float* __restrict__ St, bf16* __restrict__ y, int S, int H, int N, int Q,
             int nc) {
  constexpr int LDX = P + 8, LDC = kRows + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Qp = round16(Q);
  // stage layout: steps   Gs (kRows x kRows fp32, swizzled) | xs (kRows x LDX) | Ls;
  //               columns Hh (P x LDC) | Hl (P x LDC) | Cs (kRows x LDC)
  auto Gs = [&](int buf) { return reinterpret_cast<float*>(smem + buf * out_stage<P>()); };
  auto xs = [&](int buf) { return reinterpret_cast<bf16*>(Gs(buf) + kRows * kRows); };
  auto Ls = [&](int buf) { return reinterpret_cast<float2*>(xs(buf) + kRows * LDX); };
  auto Hh = [&](int buf) { return reinterpret_cast<bf16*>(smem + buf * out_stage<P>()); };
  auto Hl = [&](int buf) { return Hh(buf) + P * LDC; };
  auto Cs = [&](int buf) { return Hl(buf) + P * LDC; };
  // the tiles with the most steps start first
  const int tile = gridDim.x - 1 - blockIdx.x, t0 = tile * kRows;
  const int h = blockIdx.y, c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  const size_t bch = ((size_t)b * nc + c) * H + h;
  const float2* Lc = L + bch * Qp;
  const float* Gc = G + ((size_t)b * nc + c) * Qp * Qp;
  const char* Sc = reinterpret_cast<const char*>(St + bch * P * N);
  const int n_inter = (N + kRows - 1) / kRows, n_all = n_inter + tile + 1;

  auto stage = [&](int buf, int i) {
    if (i < n_inter) {  // columns n0.. of C (tile rows) and of h (all P rows)
      const int n0 = i * kRows, cols = min(kRows, N - n0);
      for (int u = tid; u < P * kRows / 4; u += 128) {  // 8 columns, hi or lo
        const int p = u / 16, m = (u % 16) / 2, part = u & 1;
        const bool ok = 8 * m < cols;
        cp_async16((part ? Hl(buf) : Hh(buf)) + p * LDC + 8 * m,
                   ok ? Sc + ((size_t)p * N + n0 + 8 * m) * 4 + 16 * part : Sc, ok ? 16 : 0);
      }
      load_rows(Cs(buf), LDC, Cm + (row0 + t0) * N + n0, N, Q - t0, cols, kRows, tid, 128);
    } else {  // steps sb..: G (tile rows), x and (l2, dt)
      const int sb = (i - n_inter) * kRows;
      load_f32(Gs(buf), Gc + (size_t)t0 * Qp + sb, Qp, Qp - t0, min(kRows, Qp - sb), tid);
      load_rows(xs(buf), LDX, x + ((row0 + sb) * H + h) * P, (long long)H * P, Q - sb, P, P,
                tid, 128);
      if (tid < kRows / 2) {
        const bool ok = sb + 2 * tid < Qp;
        cp_async16(Ls(buf) + 2 * tid, ok ? Lc + sb + 2 * tid : Lc, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  stage(0, 0);
  const int r0 = t0 + 16 * w;  // this warp's rows, r0..r0+15
  const bool active = r0 < Qp;
  const int ta = r0 + g;
  const float la = active ? Lc[ta].x : 0.f, lb = active ? Lc[ta + 8].x : 0.f;
  float acc[P / 8][4] = {};
  for (int i = 0; i < n_all; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_all) {
      stage(buf ^ 1, i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active && i < n_inter) {  // C_t h^T over columns n0..
      const int n0 = i * kRows;
      for (int k = 0; k < kRows && n0 + k < N; k += 16) {
        uint32_t a[4];
        ldsm_x4(a, Cs(buf) + (16 * w + a_row(lane)) * LDC + k + a_col(lane));
#pragma unroll
        for (int pr = 0; pr < P / 16; ++pr) {
          uint32_t bh[4], bl[4];
          const int off = (16 * pr + bt_row(lane)) * LDC + k + bt_col(lane);
          ldsm_x4(bh, Hh(buf) + off);
          ldsm_x4(bl, Hl(buf) + off);
          mma(acc[2 * pr], a, bh[0], bh[1]);
          mma(acc[2 * pr], a, bl[0], bl[1]);
          mma(acc[2 * pr + 1], a, bh[2], bh[3]);
          mma(acc[2 * pr + 1], a, bl[2], bl[3]);
        }
      }
      if (i == n_inter - 1) {
        const float ea = ex2(la), eb = ex2(lb);
#pragma unroll
        for (int j = 0; j < P / 8; ++j) {
          acc[j][0] *= ea;
          acc[j][1] *= ea;
          acc[j][2] *= eb;
          acc[j][3] *= eb;
        }
      }
    } else if (active) {  // W x over steps sb.. up to the diagonal
      const int sb = (i - n_inter) * kRows;
      const bool ragged = r0 + 16 > Q;  // rows past Q in this warp's tile
      for (int j = 0; j < kRows / 16 && sb + 16 * j <= r0; ++j) {
        const int col = 16 * j + 2 * q;
        uint32_t hi[4], lo[4];
        if (ragged || sb + 16 * j == r0)
          weights<true>(Gs(buf), 16 * w + g, col, Ls(buf), la, lb, ta, sb + col, Q, hi, lo);
        else
          weights<false>(Gs(buf), 16 * w + g, col, Ls(buf), la, lb, ta, sb + col, Q, hi, lo);
#pragma unroll
        for (int pr = 0; pr < P / 16; ++pr) {
          uint32_t bk[4];
          ldsm_x4_t(bk, xs(buf) + (16 * j + a_row(lane)) * LDX + 16 * pr + a_col(lane));
          mma(acc[2 * pr], hi, bk[0], bk[1]);
          mma(acc[2 * pr], lo, bk[0], bk[1]);
          mma(acc[2 * pr + 1], hi, bk[2], bk[3]);
          mma(acc[2 * pr + 1], lo, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled next round
  }

  // y through shared memory (the ring is free), then 16-byte row stores
  bf16* ys = reinterpret_cast<bf16*>(smem);  // kRows x LDX
  if (active) {
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      bf16* yr = ys + (16 * w + g) * LDX + 8 * j + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(yr + 8 * LDX) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  for (int u = tid; u < kRows * P / 8; u += 128) {
    const int r = u / (P / 8), col = 8 * (u % (P / 8));
    if (t0 + r < Q)
      *reinterpret_cast<uint4*>(y + ((row0 + t0 + r) * H + h) * P + col) =
          *reinterpret_cast<const uint4*>(ys + r * LDX + col);
  }
}

// Workspace (one allocation, each part 256-byte aligned): G (B, nc, Qp, Qp)
// fp32, (lcum, dt) pairs (B, nc, H, Qp), chunk states (B, nc, H, P, N) fp32.
struct Layout {
  size_t l, st, total;
};
Layout layout(int B, int S, int H, int P, int N, int Q) {
  const size_t nc = S / Q, Qp = round16(Q);
  auto up = [](size_t v) { return (v + 255) / 256 * 256; };
  Layout o;
  o.l = up((size_t)B * nc * Qp * Qp * sizeof(float));
  o.st = o.l + up((size_t)B * nc * H * Qp * sizeof(float2));
  o.total = o.st + up((size_t)B * nc * H * P * N * sizeof(float));
  return o;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int P>
int launch_p(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
             bf16* y, int B, int S, int H, int N, int Q, void* work, cudaStream_t stream) {
  const int nc = S / Q, N16 = round16(N), Qp = round16(Q), tiles = (Qp + kRows - 1) / kRows;
  if (N % 8 != 0 || P * N > kMaxPN || nc > 65535 || (long long)B * nc > 65535 ||
      H > 65535 || !aligned16(x) || !aligned16(Bm) || !aligned16(Cm) || !aligned16(y) ||
      !aligned16(work))
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout(B, S, H, P, N, Q);
  float* G = static_cast<float*>(work);
  float2* L = reinterpret_cast<float2*>(static_cast<char*>(work) + lay.l);
  float* St = reinterpret_cast<float*>(static_cast<char*>(work) + lay.st);
  const size_t cb_bytes = sizeof(bf16) * 2 * kRows * (N16 + 8);
  const size_t state_bytes = sizeof(bf16) * 2 * kRows * ((P + 8) + (N16 + 8)) +
                             sizeof(float2) * 2 * kRows + sizeof(float) * 8;
  const size_t out_bytes = 2 * out_stage<P>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_scan_cb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)cb_bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_scan_state<P>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)state_bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_scan_out<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)out_bytes)) != cudaSuccess)
    return (int)err;
  ssd_scan_cb<<<dim3(tiles, nc, B), 128, cb_bytes, stream>>>(Bm, Cm, G, S, N, Q, nc);
  ssd_scan_state<P><<<dim3(H, nc, B), 256, state_bytes, stream>>>(x, dt, A, Bm, L, St, S, H,
                                                                   N, Q, nc);
  ssd_scan_pass<<<dim3((P * N / 8 + 255) / 256, H, B), 256, 0, stream>>>(St, L, H, P * N, Q,
                                                                        nc);
  ssd_scan_out<P><<<dim3(tiles, H, B * nc), 128, out_bytes, stream>>>(x, Cm, G, L, St, y, S, H,
                                                                      N, Q, nc);
  return (int)cudaGetLastError();
}

int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
           bf16* y, int B, int S, int H, int P, int N, int Q, void* work,
           cudaStream_t stream) {
  switch (P) {
    case 16: return launch_p<16>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, work, stream);
    case 32: return launch_p<32>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, work, stream);
    case 64: return launch_p<64>(x, dt, A, Bm, Cm, y, B, S, H, N, Q, work, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

bool valid_sizes(int B, int S, int H, int N, int Q) {
  return B >= 1 && S >= 1 && H >= 1 && N >= 1 && Q >= 1 && S % Q == 0;
}

}  // namespace

extern "C" {

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, int B, int S, int H, int P, int N, int Q,
                 void* stream) {
  if (!valid_sizes(B, S, H, N, Q)) return (int)cudaErrorInvalidValue;
  return simt::launch_f32(static_cast<const float*>(x), static_cast<const float*>(dt),
                          static_cast<const float*>(A), static_cast<const float*>(Bm),
                          static_cast<const float*>(Cm), static_cast<float*>(y), B, S, H, P,
                          N, Q, static_cast<cudaStream_t>(stream));
}

// bytes of the workspace ssd_scan_bf16 needs for these sizes
long long ssd_scan_bf16_workspace(int B, int S, int H, int P, int N, int Q) {
  if (!valid_sizes(B, S, H, N, Q) || P < 1) return -1;
  return (long long)tc::layout(B, S, H, P, N, Q).total;
}

int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                  const void* Cm, void* y, int B, int S, int H, int P, int N, int Q,
                  void* work, void* stream) {
  using tc::bf16;
  if (!valid_sizes(B, S, H, N, Q)) return (int)cudaErrorInvalidValue;
  return tc::launch(static_cast<const bf16*>(x), static_cast<const float*>(dt),
                    static_cast<const float*>(A), static_cast<const bf16*>(Bm),
                    static_cast<const bf16*>(Cm), static_cast<bf16*>(y), B, S, H, P, N, Q,
                    work, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
