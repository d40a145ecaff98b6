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
// At hubert-xlarge's (B 2, S 4096, H = KV = 16, D 80, bf16, bidirectional)
// 4*B*H*D*S^2 = 171.8 GFLOP, 0.174 ms, against 84 MB (0.025 ms); at
// qwen3-moe-235b-a22b's (B 2, S 4096, H 64, KV 4, D 128, causal: GQA 16)
// 550 GFLOP, 0.556 ms.
//
// Head dims 16, 32, 64, 80 and 128 (HEAD_DIMS in ops.py).  Both schedules
// need only D % 16 == 0: the SIMT one gives each thread D / 16 columns, and
// the wgmma one runs D / 16 k-steps of m64n64k16 for Q K^T and one
// m64nDk16 (n a multiple of 8) per 16 keys for P V, its tiles D / 8 core
// matrices wide.  D = 80 is hubert-xlarge's (d 1280 / 16 heads); its
// instantiations live in a translation unit of their own
// (flash_attention_d80.cu): in this one, they moved the compiler's code for
// the bf16 D = 128 kernel (one more 64-bit register hoisted; its SASS no
// longer the parent's).  The schedules' templates are in flash_simt.cuh and
// flash_fwd_wgmma.cuh, on flash_wgmma.cuh's building blocks.
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

#include "flash_simt.cuh"
#include "flash_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"

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
    case 80:
      return flash_attention_d80_f32(qq, kk, vv, oo, ll, B, Sq, Sk, H, KV, causal, window,
                                     scale, s);
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
    case 80:
      return flash_attention_d80_bf16(qq, kk, vv, oo, ll, B, Sq, Sk, H, KV, causal, scale, s);
    case 128: return wg::launch_d<128>(qq, kk, vv, oo, ll, Sq, Sk, H, KV, B, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
