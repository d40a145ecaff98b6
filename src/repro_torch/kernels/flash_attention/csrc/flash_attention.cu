// Flash attention forward for NVIDIA Hopper (sm_90a).
//
//   o = softmax(q k^T / sqrt(D) [causal]) v     q (B,Sq,H,D), k/v (B,Sk,KV,D),
//                                               o (B,Sq,H,D) in q's dtype
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention (Pallas body `_kernel`).  Same function: online softmax
// with an fp32 running max m, denominator l and accumulator, scores scaled
// by 1/sqrt(D) in fp32, o = acc / max(l, 1e-30) cast once to q's dtype.
// Causal rows sit at key positions (Sk - Sq) + i, as in models/layers.py's
// attention.  Both schedules read the model's own layout: q head h reads KV
// head h / (H / KV) in place, so neither the GQA repeat nor the (B*H, S, D)
// transpose of the Pallas wrapper (ops.py:26-32) is materialised.  Ragged Sq
// and Sk are masked (the Pallas kernel asserts S % bq == 0), and a causal
// block stops at the diagonal: a q tile reads keys up to its last row's
// position only.
//
// Bound (published H100 SXM peaks at its 700 W limit).  At the qwen3-0.6b
// prefill shape (B 2, S 4096, H 16, KV 8, D 128, bf16, causal) the work is
// 2*2*B*H*D*S(S+1)/2 = 137 GFLOP against ~101 MB of q, k, v and o: 0.139 ms
// at the 989 TFLOP/s of bf16 tensor cores and 0.030 ms at 3.35 TB/s, so the
// kernel is bound by operations, and only wgmma reaches that rate.
//
// bf16: the wgmma schedule (flash_fwd_wgmma).  One block of two warpgroups
// per (128-row q tile, q head, batch); each warpgroup owns 64 q rows.  Under
// causal the block index is reversed, so the tiles with the most keys start
// first.  The q tile is copied once into shared memory; K and V tiles of 64
// keys pass through a two-stage ring filled by cp.async (16-byte copies,
// zero-filled past Sk), so tile j + 1 loads while tile j computes: 96 KB of
// shared memory at D = 128, two blocks to an SM.  Tiles are stored as wgmma's
// core matrices (8 rows x 16 bytes, 128 contiguous bytes each, no swizzle):
// eight consecutive threads fill one core matrix, so the copies and
// wgmma's reads are free of bank conflicts.  S = Q K^T is
// wgmma.m64n64k16 with both operands in shared memory (K as stored is the
// K-major B operand).  The online softmax runs in fp32 on the accumulator
// fragment: a row lives in the four lanes of a quad, its max and sum are two
// shuffles, the scale 1/sqrt(D) is folded with log2(e) into one exp2f on the
// fp32 scores, and the masks run only on a tile that crosses the diagonal or
// Sk.  P stays in registers and becomes wgmma's A operand directly (the
// accumulator fragment of m64nN is the A fragment of m64k16, the FA3
// arrangement), split into two bf16 parts, hi = bf16(p) and lo = bf16(p -
// hi): rounded once, each weight would carry up to 2^-9 of itself into o,
// which the first causal rows (a few keys, nothing to average) cannot absorb
// under the card's limit of 1e-3 abs + 1e-2 rel, while hi + lo carries
// 2^-17.  O += P V is then two wgmma.m64nDk16 per 16 keys, with V in shared
// memory as the MN-major B operand (the transpose bit): half again the
// tensor work of hi alone.  l is summed from the unrounded p.  128
// registers a thread, no spills.  What this leaves against the bound: no
// warp specialisation (every thread issues copies, then waits on the ring
// before each tile, and two barriers a tile keep the block's warpgroups in
// step), no ping-pong between the two warpgroups (softmax and products of
// one warpgroup alternate, so the tensor cores idle unless the SM's other
// warpgroups fill the gap), no persistent blocks (each block pays its own
// prologue and epilogue), and 64-key tiles, whose m64n64k16 products read
// both operands from shared memory for only 64 columns of S.
//
// fp32: the SIMT schedule (flash_fwd).  Its products are fp32 FMA on the CUDA
// cores (no TF32, full-precision expf), which keeps the fp32 tolerance of
// 2e-5 but caps it at the 67 TFLOP/s fp32 rate.  One block of 256 threads
// per (64-row q tile, q head, batch); the KV loop runs inside the block and
// the state lives in registers: thread (ty, tx) = (tid / 16, tid % 16) owns
// rows 4ty..4ty+3 and the columns tx + 16j of both the 64 x 64 score tile
// and the 64 x D accumulator, so a row's max and sum are shuffles within 16
// lanes of one warp.  Shared memory holds the fp32 q tile, one K and one V
// tile (64 keys) and the probabilities of the tile (115 KB at D = 128, rows
// padded by one float against bank conflicts).
//
// Launch: on the caller's stream, no allocation, no synchronisation.  The
// caller passes the scale (1/sqrt(D) rounded once to fp32, as the reference
// rounds it).  The entry points return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
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

template <int D>
int launch_d(const float* q, const float* k, const float* v, float* o, int Sq, int Sk,
             int H, int KV, int B, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<float, D><<<grid, kThreads, bytes, stream>>>(q, k, v, o, Sq, Sk, H, KV, causal,
                                                         scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: the wgmma schedule
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int BQ = 128;        // q rows per block, 64 per warpgroup
constexpr int BKV = 64;        // keys per K/V tile
constexpr int kStages = 2;     // K/V tiles in flight
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(BQ + 2 * kStages * BKV) * D;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, the bytes past `src_bytes` zeroed
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's generic-proxy writes to shared memory visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma's registers across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a core-matrix (no swizzle) layout: the
// start address, LBO = bytes between core matrices along the reduction (K)
// dimension, SBO = bytes between core matrices along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 64 fp32) = [d +] A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N fp32) += A (registers, bf16) * B (smem, MN-major), N = the head dim
template <int N> struct WgmmaRS;

template <> struct WgmmaRS<16> {
  __device__ __forceinline__ static void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<32> {
  __device__ __forceinline__ static void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};


// Rows [0, ROWS) of a (rows, D) bf16 tile whose row r starts at src + r * ld,
// into shared memory at dst as core matrices: row r, columns 8c..8c+7 at
// byte ((r / 8) * (D / 8) + c) * 128 + (r % 8) * 16, i.e. chunk i of the
// block's copies lands at byte 16 i.  Rows >= `valid` are zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int valid,
                                          long long ld, int tid) {
  constexpr int kChunks = ROWS * D / 8;
#pragma unroll
  for (int u = 0; u < (kChunks + kThreads - 1) / kThreads; ++u) {
    const int i = tid + u * kThreads;
    if (kChunks % kThreads != 0 && i >= kChunks) break;
    const int r = (i / D) * 8 + (i & 7);
    const int c = (i >> 3) % (D / 8);
    const bool ok = r < valid;
    cp_async16(dst + 16 * i, ok ? src + r * ld + 8 * c : src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: 128 registers
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int B, int Sq, int Sk,
                int H, int KV, int causal, float scale_log2) {
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
    bf16* row = o + (((long long)b * Sq + qi) * H + h) * D + 2 * quad;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) = __floats2bfloat162_rn(
          acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
  }
}

template <int D>
int launch_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, int Sq, int Sk, int H,
             int KV, int B, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((Sq + BQ - 1) / BQ) * H * B;
  flash_fwd_wgmma<D><<<blocks, kThreads, bytes, stream>>>(q, k, v, o, B, Sq, Sk, H, KV,
                                                          causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                        int Sq, int Sk, int H, int KV, int D, int causal, float scale,
                        void* stream) {
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return simt::launch_d<16>(qq, kk, vv, oo, Sq, Sk, H, KV, B, causal, scale, s);
    case 32: return simt::launch_d<32>(qq, kk, vv, oo, Sq, Sk, H, KV, B, causal, scale, s);
    case 64: return simt::launch_d<64>(qq, kk, vv, oo, Sq, Sk, H, KV, B, causal, scale, s);
    case 128: return simt::launch_d<128>(qq, kk, vv, oo, Sq, Sk, H, KV, B, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                         int Sq, int Sk, int H, int KV, int D, int causal, float scale,
                         void* stream) {
  using wg::bf16;
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return wg::launch_d<16>(qq, kk, vv, oo, Sq, Sk, H, KV, B, causal, scale, s);
    case 32: return wg::launch_d<32>(qq, kk, vv, oo, Sq, Sk, H, KV, B, causal, scale, s);
    case 64: return wg::launch_d<64>(qq, kk, vv, oo, Sq, Sk, H, KV, B, causal, scale, s);
    case 128: return wg::launch_d<128>(qq, kk, vv, oo, Sq, Sk, H, KV, B, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
