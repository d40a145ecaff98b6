// Split-KV decode attention for NVIDIA Hopper (sm_90a): one query row a
// sequence against its KV cache, read once and in place.
//
//   o = softmax(q k^T / sqrt(D) over the kept keys [lo, hi)) v
//        q (B, 1, H, D) bf16 or fp32, contiguous; k/v (B, Sk, KV, D) bf16
//        or fp32, any strides with a contiguous head dim; o (B, 1, H, D)
//        in q's dtype
//
// Replaces no TPU kernel.  The reference's one-row branch
// (src/repro/models/layers.py::attention, sq == 1) is plain jnp, and the
// port's twin of it (ref.py) repeats each KV head H / KV times and widens
// the cache to fp32 before two GEMVs: three writes and four reads of a
// cache that only has to be read once.  This kernel is added because that
// branch sets the pace of a deep decode step.
//
// Bound: bytes.  A decode step reads every kept key and value of every
// (row, KV head) once and does 4 * G operations a cached element (G = H /
// KV query heads share it): at qwen3-0.6b's decode_32k (B 8, 32,768 keys,
// KV 8, D 128, bf16, G 2) that is 1.074 GB a layer, 0.32 ms at 3.35 TB/s,
// against 4.4 GFLOP, 0.07 ms even at fp32's 67 TFLOP/s.  The design keeps
// HBM busy:
//  * Grid (KV head, split, row).  A block streams one split of the kept
//    key range of one (row, KV head) and computes all G query heads of the
//    group from each K/V tile it loads, so no byte of the cache is read
//    twice.  The host picks the splits from the shape (ops.split_plan):
//    about 16 blocks an SM in all, so that the last wave is a small part
//    of the launch, each split at least a few tiles long.  Blocks are
//    independent; each writes its split's unnormalised fp32 (o, m, l) to
//    scratch and a second small launch (combine) merges the splits of
//    each (row, head) and writes o once.
//  * Loads: cp.async, 16 bytes a thread, into a ring of STAGES = 2 tiles
//    of TILE = 64 keys (K and V, 68 KB at D 128 in bf16): the next tile is
//    in flight while one is used, and three blocks share an SM, so some
//    100 KB an SM are in flight.  Measured at the decode_32k shape, two
//    tiles in flight a block at two blocks an SM, or 32-key tiles, or 8
//    warps a block, were no faster (PERF.md, section 6).  Rows of the
//    ring are padded by 16 bytes, so the score loop's reads (16 keys a
//    warp, 16-byte pieces) meet no bank conflict.  Keys past the split's
//    end are zero-filled, never read from memory.
//  * Arithmetic: the reference's precision.  q * (1/sqrt(D)) is rounded
//    once to fp32 (ref.py's q.float() * scale); K and V are widened to
//    fp32 in registers; scores, the online softmax's running max and sum,
//    and the p . v accumulators are fp32, p included.  A masked key is
//    never visited, which is what the reference's -1e30 amounts to
//    (exp(-1e30 - m) == 0 in fp32).
//  * Warps: each of the 4 warps takes 16 keys of a tile and keeps its own
//    (m, l, acc) for the G heads: for scores a key is two lanes, each half
//    of D, joined by one shuffle; for p . v a lane owns CPL columns (1,
//    2 or 4: all 32 lanes at D 32, 64 and 128, 16 lanes at D 16, 20 at D
//    80) and reads each key's p from the lane that scored it.  The
//    warps' states are merged in shared memory at the end of the split.
//  * Groups of 16 query heads (qwen3-moe-235b-a22b, llama3-405b) do 16
//    times the fp32 work a byte on SIMT cores, and there that work, not
//    the bytes, bounds the kernel (some 15 % of the byte bound at B 8,
//    32,768 keys; PERF.md, section 6).  No configuration of the benchmark
//    decodes at that group size.
//
// Template on the cache's element type T, the head dim D (16, 32, 64, 80
// (hubert-xlarge), 128) and GM, the group size rounded up to a power of
// two (1 .. 16); the group's actual size G <= GM is an argument (heads
// G .. GM - 1 are zero rows of q whose results are not written).  Splits,
// key range and strides are arguments, so one kernel takes every shape
// the port decodes.  q's dtype is a flag: it is read once a block.  The
// entry points return cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;           // tiles a block holds: one used, one in flight
constexpr int LPK = 2;              // lanes that score a key (fewer where D is short)
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* po;  // (B, H, nsplit, D) unnormalised o of each split
  float* pm;  // (B, H, nsplit) running max of each split
  float* pl;  // (B, H, nsplit) sum of exp(s - m) of each split
  long long ksb, kss, ksh;  // k's strides in elements: row, key, KV head
  long long vsb, vss, vsh;
  int q_bf16;
  int H, KV, G;
  int lo, hi, chunk, nsplit;
  float scale;
};

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

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the 16 / sizeof(T) elements of one 16-byte piece in shared memory, as fp32
template <typename T>
struct Piece;
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const unsigned char* p, float* x) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    x[0] = bf_lo(w.x); x[1] = bf_hi(w.x); x[2] = bf_lo(w.y); x[3] = bf_hi(w.y);
    x[4] = bf_lo(w.z); x[5] = bf_hi(w.z); x[6] = bf_lo(w.w); x[7] = bf_hi(w.w);
  }
};
template <>
struct Piece<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const unsigned char* p, float* x) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
  }
};

// C consecutive elements of a row in shared memory (a lane's columns), as fp32
template <typename T, int C>
__device__ __forceinline__ void load_cols(const unsigned char* p, float* x) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (C == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      x[0] = bf_lo(w.x); x[1] = bf_hi(w.x); x[2] = bf_lo(w.y); x[3] = bf_hi(w.y);
    } else if constexpr (C == 2) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
      x[0] = bf_lo(w); x[1] = bf_hi(w);
    } else {
      x[0] = __uint_as_float(uint32_t(*reinterpret_cast<const uint16_t*>(p)) << 16);
    }
  } else {
    if constexpr (C == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
    } else if constexpr (C == 2) {
      const float2 w = *reinterpret_cast<const float2*>(p);
      x[0] = w.x; x[1] = w.y;
    } else {
      x[0] = *reinterpret_cast<const float*>(p);
    }
  }
}

template <typename T, int D>
struct Shape {
  static constexpr int VEC = Piece<T>::N;                 // elements a 16-byte piece
  static constexpr int PIECES = D / VEC;                  // pieces a row
  static constexpr int LANES = PIECES < LPK ? PIECES : LPK;  // lanes that score a key
  static constexpr int PART = PIECES / LANES;             // pieces a scoring lane
  static constexpr int KPW = 32 / LANES;                  // keys a warp a tile
  static constexpr int TILE = WARPS * KPW;                // keys a stage
  static constexpr int ROW = D * (int)sizeof(T) + 16;     // padded row, bytes
  static constexpr int STAGE = 2 * TILE * ROW;            // K and V of a tile
  static constexpr int RING = STAGES * STAGE;
  // p . v columns a lane (a power of two that divides D), on D / CPL lanes
  static constexpr int CPL = D > 64 ? 4 : D > 32 ? 2 : 1;
  static constexpr int PV_LANES = D / CPL;
  static_assert(PIECES % LANES == 0, "a scoring lane takes whole pieces");
  static_assert(D % CPL == 0 && PV_LANES <= 32, "p . v columns fit the warp");
};

template <typename T, int D, int GM>
constexpr int smem_bytes() {
  return Shape<T, D>::RING + GM * D * (int)sizeof(float);
}

template <typename T, int D, int GM>
__global__ void __launch_bounds__(THREADS) split_kernel(const Args a) {
  using S = Shape<T, D>;
  constexpr int VEC = S::VEC, ROW = S::ROW, CPL = S::CPL, KPW = S::KPW, TILE = S::TILE;
  static_assert(WARPS * GM * (D + 2) * (int)sizeof(float) <= S::RING,
                "the warps' states must fit in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::RING);  // (GM, D), scaled

  const int kvh = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = a.lo + split * a.chunk;
  const int k1 = min(k0 + a.chunk, a.hi);
  const long long head0 = (long long)b * a.H + (long long)kvh * a.G;  // (b, first head)

  if (k0 >= k1) {  // no kept key: nothing to load; combine skips the split
    for (int g = tid; g < a.G; g += THREADS) {
      const long long p = (head0 + g) * a.nsplit + split;
      a.pm[p] = -INFINITY;
      a.pl[p] = 0.f;
    }
    return;
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int ntiles = (k1 - k0 + TILE - 1) / TILE;

  auto load_tile = [&](int t) {
    const uint32_t base = ring + (t % STAGES) * S::STAGE;
    const int key0 = k0 + t * TILE;
#pragma unroll
    for (int i = tid; i < TILE * S::PIECES; i += THREADS) {
      const int r = i / S::PIECES, c = i % S::PIECES;
      const int key = key0 + r;
      const bool ok = key < k1;
      const long long kk = ok ? key : k0;
      cp_async16(base + r * ROW + c * 16, kb + kk * a.kss + c * VEC, ok ? 16 : 0);
      cp_async16(base + TILE * ROW + r * ROW + c * 16, vb + kk * a.vss + c * VEC,
                 ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  for (int i = tid; i < GM * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float x = 0.f;
    if (g < a.G) {
      const long long off = (head0 + g) * D + d;
      x = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off])
                   : static_cast<const float*>(a.q)[off];
      x *= a.scale;
    }
    qs[i] = x;
  }

  float m[GM], l[GM], s[GM], acc[GM][CPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
  }
  const int kt = lane % KPW, part = lane / KPW;  // the key this lane scores, and its part
  const bool pv_lane = lane < S::PV_LANES;             // owns p . v columns

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + STAGES - 1 < ntiles) load_tile(t + STAGES - 1);
    cp_async_commit();

    const int first = k0 + t * TILE + warp * KPW;
    const int nvalid = min(KPW, k1 - first);
    if (nvalid <= 0) continue;  // warp-uniform: this warp's keys are past the split
    const unsigned char* kt_rows = smem + (t % STAGES) * S::STAGE + warp * KPW * ROW;
    const unsigned char* vt_rows = kt_rows + TILE * ROW;

    // scores: lane (kt, part) takes part of key kt's D against every head
    const unsigned char* krow = kt_rows + kt * ROW + part * S::PART * 16;
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll
    for (int c = 0; c < S::PART; ++c) {
      float kx[VEC];
      Piece<T>::load(krow + c * 16, kx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= a.G) break;
        const float* qg = qs + g * D + (part * S::PART + c) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qg + e);
          s[g] = fmaf(qv.x, kx[e], s[g]);
          s[g] = fmaf(qv.y, kx[e + 1], s[g]);
          s[g] = fmaf(qv.z, kx[e + 2], s[g]);
          s[g] = fmaf(qv.w, kx[e + 3], s[g]);
        }
      }
    }

    // online softmax over the warp's keys, one head at a time; s <- p
    const bool valid = kt < nvalid;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= a.G) break;
      float sv = s[g];
#pragma unroll
      for (int off = KPW; off < 32; off <<= 1) sv += __shfl_xor_sync(FULL, sv, off);
      float mt = valid ? sv : -INFINITY;
#pragma unroll
      for (int off = KPW / 2; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
      const float mnew = fmaxf(m[g], mt);  // finite: key 0 of the warp is valid
      const float corr = expf(m[g] - mnew);
      const float p = valid ? expf(sv - mnew) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = KPW / 2; off > 0; off >>= 1) ps += __shfl_xor_sync(FULL, ps, off);
      l[g] = l[g] * corr + ps;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[g][c] *= corr;
      m[g] = mnew;
      s[g] = p;
    }

    // p . v: lane owns columns lane * CPL ..; key j's p is on lane j
#pragma unroll 4
    for (int j = 0; j < KPW; ++j) {
      if (j >= nvalid) break;
      float vx[CPL];
      if (pv_lane) {
        load_cols<T, CPL>(vt_rows + j * ROW + lane * CPL * (int)sizeof(T), vx);
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) vx[c] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= a.G) break;
        const float pj = __shfl_sync(FULL, s[g], j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] = fmaf(pj, vx[c], acc[g][c]);
      }
    }
  }

  // merge the warps' states in the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // (WARPS, GM)
  float* wl = wm + WARPS * GM;                 // (WARPS, GM)
  float* wacc = wl + WARPS * GM;               // (WARPS, GM, D)
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      wm[warp * GM + g] = m[g];
      wl[warp * GM + g] = l[g];
    }
    if (pv_lane) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) wacc[(warp * GM + g) * D + lane * CPL + c] = acc[g][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < a.G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * GM + g]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = wm[w * GM + g];
      if (mw == -INFINITY) continue;  // a warp that saw no key
      const float e = expf(mw - mx);
      sum = fmaf(wl[w * GM + g], e, sum);
      o = fmaf(wacc[(w * GM + g) * D + d], e, o);
    }
    const long long p = (head0 + g) * a.nsplit + split;
    a.po[p * D + d] = o;
    if (d == 0) {
      a.pm[p] = mx;
      a.pl[p] = sum;
    }
  }
}

// o[b, h] = sum_s exp(m_s - M) o_s / sum_s exp(m_s - M) l_s; one block a
// (row, head), one thread a column
__global__ void combine_kernel(const float* __restrict__ po, const float* __restrict__ pm,
                               const float* __restrict__ pl, void* out, int out_bf16,
                               int nsplit, int D) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = pm + bh * nsplit;
  const float* l = pl + bh * nsplit;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m[s]);
  float sum = 0.f, o = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    if (m[s] == -INFINITY) continue;  // a split with no kept key
    const float e = expf(m[s] - mx);
    sum = fmaf(l[s], e, sum);
    o = fmaf(po[(bh * nsplit + s) * D + d], e, o);
  }
  const float r = o / sum;
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[bh * D + d] = __float2bfloat16(r);
  else
    static_cast<float*>(out)[bh * D + d] = r;
}

constexpr int MAX_DEVICES = 64;

// The split kernel's dynamic shared memory limit, raised once an
// instantiation and device (a process may decode on several): a decode
// step launches the kernel once a layer, and the host's issue cost paces it.
template <typename T, int D, int GM>
cudaError_t allow_smem(int smem) {
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(split_kernel<T, D, GM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

template <typename T, int D, int GM>
int launch(const Args& a, int B, void* out, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, D, GM>();
  cudaError_t e = allow_smem<T, D, GM>(smem);
  if (e != cudaSuccess) return (int)e;
  split_kernel<T, D, GM><<<dim3(a.KV, a.nsplit, B), THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<B * a.H, D, 0, stream>>>(a.po, a.pm, a.pl, out, a.q_bf16, a.nsplit, D);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_group(const Args& a, int B, void* out, cudaStream_t s) {
  if (a.G <= 1) return launch<T, D, 1>(a, B, out, s);
  if (a.G <= 2) return launch<T, D, 2>(a, B, out, s);
  if (a.G <= 4) return launch<T, D, 4>(a, B, out, s);
  if (a.G <= 8) return launch<T, D, 8>(a, B, out, s);
  if (a.G <= 16) return launch<T, D, 16>(a, B, out, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* out, void* scratch, int B, int H,
        int KV, int D, int q_bf16, long long ksb, long long kss, long long ksh, long long vsb,
        long long vss, long long vsh, int lo, int hi, int chunk, int nsplit, float scale,
        void* stream) {
  if (KV < 1 || H % KV != 0 || nsplit < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  const long long parts = (long long)B * H * nsplit;
  a.po = static_cast<float*>(scratch);
  a.pm = a.po + parts * D;
  a.pl = a.pm + parts;
  a.ksb = ksb; a.kss = kss; a.ksh = ksh;
  a.vsb = vsb; a.vss = vss; a.vsh = vsh;
  a.q_bf16 = q_bf16;
  a.H = H; a.KV = KV; a.G = H / KV;
  a.lo = lo; a.hi = hi; a.chunk = chunk; a.nsplit = nsplit;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return by_group<T, 16>(a, B, out, s);
    case 32: return by_group<T, 32>(a, B, out, s);
    case 64: return by_group<T, 64>(a, B, out, s);
    case 80: return by_group<T, 80>(a, B, out, s);
    case 128: return by_group<T, 128>(a, B, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// the cache in bf16 (q bf16 or fp32: q_bf16); scratch holds B*H*nsplit*(D+2) fp32
int decode_attention_bf16(const void* q, const void* k, const void* v, void* out,
                          void* scratch, int B, int H, int KV, int D, int q_bf16,
                          long long ksb, long long kss, long long ksh, long long vsb,
                          long long vss, long long vsh, int lo, int hi, int chunk,
                          int nsplit, float scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, out, scratch, B, H, KV, D, q_bf16, ksb, kss, ksh, vsb,
                            vss, vsh, lo, hi, chunk, nsplit, scale, stream);
}

// the cache in fp32
int decode_attention_f32(const void* q, const void* k, const void* v, void* out,
                         void* scratch, int B, int H, int KV, int D, int q_bf16,
                         long long ksb, long long kss, long long ksh, long long vsb,
                         long long vss, long long vsh, int lo, int hi, int chunk,
                         int nsplit, float scale, void* stream) {
  return run<float>(q, k, v, out, scratch, B, H, KV, D, q_bf16, ksb, kss, ksh, vsb, vss,
                    vsh, lo, hi, chunk, nsplit, scale, stream);
}

}  // extern "C"
