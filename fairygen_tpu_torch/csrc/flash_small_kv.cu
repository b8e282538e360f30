// K4, max and masked forms: one-k-tile attention with the row max taken over
// every key at once, on head-major bf16 q/k/v (B*N, S_pad, D), D = 64 or 128.
//
// Replaces the TPU kernel fairygen_tpu/ops/flash_attention.py
//   K4 _fa_small_kv_kernel with bounded=False (masked=False: the max form;
//      masked=True: key columns >= sk_actual set to -1e30 first)
// which the generic entry _flash_fwd_impl picks whenever the padded keys
// fit one TPU k tile (at most 1024 keys).  The bounded form (no max, the
// pad correction) is csrc/flash_attention.cu's fa_small_kv_kernel.
// Contract (the JAX package's): q carries scale * log2(e); the whole key
// range is one tile, so the kernel takes m = max over all keys of s, then
// p = exp2(s - m) once, l = sum p in fp32, rounds p to bf16 before p v with
// fp32 accumulation, and writes pv / l.  That is the Pallas kernel's
// rounding; an online softmax (K5) rounds p against a running max instead.
// Masked columns are set to -1e30 before the max, so exp2 gives exact zeros
// whatever the masked key and value rows hold (a caller's kv_len may leave
// them non-zero).
//
// Bound on the H100: operations (4 * Sq * Sk * D flops per head against
// (2 Sq + 2 Sk) * D * 2 bytes).  Design: two passes over the keys inside
// one CTA of 64 query rows (4 warps x 16 rows, q held as mma A fragments).
// Pass 1 streams K in 64-key tiles and keeps each row's max of S = Q K^T;
// pass 2 streams K and V again, recomputes the same S (the same products
// in the same order, so bit for bit the values the max was taken over),
// and accumulates l and P V on the tensor cores (mma.sync.m16n8k16, bf16
// in, fp32 accumulate).  At 1024 keys x 64 K and V are 256 KB, over the
// 227 KB of shared memory, so they are streamed, not held.  Tiles past the
// last valid key add exact zeros and are skipped.  No TMA / wgmma /
// pipelining yet: this is the first, simple kernel.
#include "flash_common.cuh"

namespace {

constexpr float kMaskedLogit = -1e30f;  // the Pallas kernel's _NEG_INF

template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
fa_small_kv_max_kernel(const bf16* __restrict__ qh, const bf16* __restrict__ kh,
                       const bf16* __restrict__ vh, bf16* __restrict__ out, int sq_pad,
                       int sk_actual, int sk_pad) {
  __shared__ __align__(16) bf16 Ks[kTile * row_stride<D>()];
  __shared__ __align__(16) bf16 Vt[D * kTStride];
  const int bn = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;

  uint32_t qa[D / 16][4];
  load_a(qa, qh + ((size_t)bn * sq_pad + q0 + warp * 16) * D, D, g, tg);
  const bf16* kb = kh + (size_t)bn * sk_pad * D;
  const bf16* vb = vh + (size_t)bn * sk_pad * D;

  auto mask = [&](float (&s)[8][4], int k0) {
    if (kMasked && k0 + kTile > sk_actual) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + nt * 8 + tg * 2 + (i & 1) >= sk_actual) s[nt][i] = kMaskedLogit;
    }
  };

  // pass 1: each row's max over every key
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int k0 = 0; k0 < sk_actual; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_rows<D>(Ks, kb + (size_t)k0 * D);
    __syncthreads();
    float s[8][4];
    tile_scores<D>(s, qa, Ks, g, tg);
    mask(s, k0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);

  // pass 2: p = exp2(s - m), l = sum p, o = bf16(p) v
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < sk_actual; k0 += kTile) {
    __syncthreads();
    load_rows<D>(Ks, kb + (size_t)k0 * D);
    load_rows_t<D>(Vt, vb + (size_t)k0 * D);
    __syncthreads();
    float s[8][4];
    tile_scores<D>(s, qa, Ks, g, tg);
    mask(s, k0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    tile_pv<D>(o, s, Vt, g, tg);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t r0 = (size_t)bn * sq_pad + q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(out + r0 * D + col) =
        pack_bf16(__fdiv_rn(o[dt][0], l0), __fdiv_rn(o[dt][1], l0));
    *reinterpret_cast<uint32_t*>(out + r1 * D + col) =
        pack_bf16(__fdiv_rn(o[dt][2], l1), __fdiv_rn(o[dt][3], l1));
  }
}

template <int D, bool kMasked>
int launch(const void* qh, const void* kh, const void* vh, void* out, int BN, int sq_pad,
           int sk_actual, int sk_pad, cudaStream_t stream) {
  dim3 grid(sq_pad / kTile, BN);
  fa_small_kv_max_kernel<D, kMasked><<<grid, kThreads, 0, stream>>>(
      (const bf16*)qh, (const bf16*)kh, (const bf16*)vh, (bf16*)out, sq_pad, sk_actual, sk_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// qh, out: (BN, sq_pad, d) bf16; kh, vh: (BN, sk_pad, d) bf16; sq_pad and
// sk_pad multiples of 64, sk_pad <= 1024 (checked by the Python wrapper);
// 1 <= sk_actual <= sk_pad, the masked form when sk_actual < sk_pad.
extern "C" int fg_flash_small_kv_max(const void* qh, const void* kh, const void* vh, void* out,
                                     int BN, int sq_pad, int sk_actual, int sk_pad, int d,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool masked = sk_actual < sk_pad;
  if (d == 64)
    return masked ? launch<64, true>(qh, kh, vh, out, BN, sq_pad, sk_actual, sk_pad, st)
                  : launch<64, false>(qh, kh, vh, out, BN, sq_pad, sk_actual, sk_pad, st);
  if (d == 128)
    return masked ? launch<128, true>(qh, kh, vh, out, BN, sq_pad, sk_actual, sk_pad, st)
                  : launch<128, false>(qh, kh, vh, out, BN, sq_pad, sk_actual, sk_pad, st);
  return (int)cudaErrorInvalidValue;
}
