// Flash attention forward for NVIDIA Hopper (sm_90a).
//
//   o = softmax(q k^T / sqrt(D) [causal, window]) v
//                                               q (B,Sq,H,D), k/v (B,Sk,KV,D),
//                                               o (B,Sq,H,D) in q's dtype
//   lse = m + log(l)                            (B,H,Sq) fp32, when asked for
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
// Sliding window (window > 0, only under causal; the reference's
// _block_mask, models/layers.py:197-203, which the TPU kernel lacks): row
// i keeps key j iff 0 <= pos_i - j < window.  A q tile's KV loop starts at
// the tile holding the first key its first row sees, pos_first - window
// + 1, so the work is O(S * window) and not O(S^2); a warpgroup skips the
// tiles its own rows cannot see, and the window mask runs only on a tile
// that crosses the window's lower edge.  A row can find every key of a
// tile masked (the tile lies before its window) before it meets one it
// sees; while a row's running max is still the mask value, its
// probabilities are taken as 0 (the reference's scan gets 1 there and
// clears it later with a correction of exp(-huge) = 0; the fp32 result is
// the same).  No row is masked in full: its own diagonal key is kept.  The
// launches without a window run the unwindowed code unchanged, so their
// results are the same bit for bit: the fp32 schedule takes the window as
// a template flag, the bf16 one as a kernel of its own in a translation
// unit of its own (flash_attention_window.cu; the building blocks of both
// in flash_wgmma.cuh).  In this unit, even as a kernel apart, the windowed
// kernel moved the compiler's hoisting in the unwindowed D = 128 one: 8
// bytes spilled and the causal qwen3-0.6b prefill ran 8 % slower.
//
// Bound (published H100 SXM peaks at its 700 W limit).  At the qwen3-0.6b
// prefill shape (B 2, S 4096, H 16, KV 8, D 128, bf16, causal) the work is
// 2*2*B*H*D*S(S+1)/2 = 137 GFLOP against ~101 MB of q, k, v and o: 0.139 ms
// at the 989 TFLOP/s of bf16 tensor cores and 0.030 ms at 3.35 TB/s, so the
// kernel is bound by operations, and only wgmma reaches that rate.  At the
// zamba2-1.2b prefill shape (B 2, S 8192, H = KV = 32, D 64, bf16, causal,
// window 4096) a head keeps W(W+1)/2 + (S - W)W = 25.17 M (q, k) pairs:
// 4*D*(B*H)*25.17e6 = 4*64*64*25.17e6 = 412 GFLOP, 0.417 ms at 989 TFLOP/s,
// against 268 MB of q, k, v and o (0.080 ms): bound by operations as well.
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
// The row log-sum-exp.  The training path's backward (models/layers.py's
// FlashTrain, the port of the reference's _flash_train) rebuilds each block's
// probabilities from it, so with a non-null `lse` both schedules also write
// m + log(max(l, 1e-30)) per row in the scaled units of the scores, the lse
// of the reference's _flash_fwd_scan (models/layers.py:243-244): one fp32
// store a row after the KV loop, by one lane of the row's lanes.  The wgmma
// schedule keeps m unscaled and sums exp2, so it writes
// (m * scale * log2(e) + log2(l)) * ln(2).  With a null `lse` (prefill)
// nothing else changes.
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

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                        int B, int Sq, int Sk, int H, int KV, int D, int causal,
                        int window, float scale, void* stream) {
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return simt::launch_d<16>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, window, scale, s);
    case 32:
      return simt::launch_d<32>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, window, scale, s);
    case 64:
      return simt::launch_d<64>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, window, scale, s);
    case 128:
      return simt::launch_d<128>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int Sq, int Sk, int H, int KV, int D, int causal,
                         int window, float scale, void* stream) {
  if (causal && window > 0)
    return flash_attention_window_bf16(q, k, v, o, lse, B, Sq, Sk, H, KV, D, window, scale,
                                       stream);
  using wg::bf16;
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return wg::launch_d<16>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, scale, s);
    case 32: return wg::launch_d<32>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, scale, s);
    case 64: return wg::launch_d<64>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, scale, s);
    case 128: return wg::launch_d<128>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
