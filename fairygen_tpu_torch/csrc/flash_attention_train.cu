// K5 at head dim 128 and K6a: the generic flash attention with a running
// max and its LSE-emitting forward, on head-major bf16 q/k/v (B*N, S_pad,
// 128).  K5 at head dim 64 is the Hopper kernel of
// flash_attention_online.cu; the two backward kernels K6b and K6c are the
// Hopper kernels of flash_attention_bwd.cu.
//
// Replaces the TPU kernels fairygen_tpu/ops/flash_attention.py:
//   K5  _fa_kernel          forward, online softmax (no-grad generic entry)
//   K6a _fa_fwd_lse_kernel  the same plus the per-row base-2 logsumexp
// Contract (the JAX package's): q carries scale * log2(e), so P =
// exp2(s - m); key columns >= sk_actual are masked (P = 0 exactly, as
// exp2(-inf)); lse = m + log2(l) is one fp32 value per row (the TPU's
// 128-lane broadcast is a layout artefact and is not kept).
//
// Bound on the H100: operations.  4 * Sq * Sk * 128 flops per head against
// a few bytes per row, far above the ridge.  Design: a CTA owns 64 rows
// (4 warps x 16), the TPU's sequential grid axis becomes a loop over
// 64-key tiles inside the CTA, K is staged row-major and V transposed in
// padded shared memory, and every product runs on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  The accumulators of S
// become the A fragments of P V without a shuffle.  The loop stops at the
// last tile holding a valid key: tiles past it contribute exact zeros.
// No TMA / wgmma / pipelining yet: these are the first, simple kernels.
#include "flash_common.cuh"

namespace {

// K5 at head dim 128 (kLse = false) and K6a (kLse = true)
template <bool kLse, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const bf16* __restrict__ qh, const bf16* __restrict__ kh,
              const bf16* __restrict__ vh, bf16* __restrict__ out, float* __restrict__ lse,
              int sq_pad, int sk_actual, int sk_pad) {
  __shared__ __align__(16) bf16 Ks[kTile * row_stride<D>()];
  __shared__ __align__(16) bf16 Vt[D * kTStride];
  const int bn = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;

  uint32_t qa[D / 16][4];
  load_a(qa, qh + ((size_t)bn * sq_pad + q0 + warp * 16) * D, D, g, tg);
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const bf16* kb = kh + (size_t)bn * sk_pad * D;
  const bf16* vb = vh + (size_t)bn * sk_pad * D;
  for (int k0 = 0; k0 < sk_actual; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_rows<D>(Ks, kb + (size_t)k0 * D);
    load_rows_t<D>(Vt, vb + (size_t)k0 * D);
    __syncthreads();

    float s[8][4];
    tile_scores<D>(s, qa, Ks, g, tg);
    if (k0 + kTile > sk_actual) {  // the tile holding the end of the keys
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + nt * 8 + tg * 2 + (i & 1) >= sk_actual) s[nt][i] = -INFINITY;
    }
    // every processed tile holds a valid key, so the new max is finite and
    // the first tile's rescale is exp2(-inf) = 0
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
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
  if (kLse && tg == 0) {
    lse[r0] = m0 + log2f(l0);
    lse[r1] = m1 + log2f(l1);
  }
}

}  // namespace

// Shapes (checked by the Python wrappers): qh, out (BN, sq_pad, D) bf16;
// kh, vh (BN, sk_pad, D) bf16; lse (BN, sq_pad) fp32; sq_pad and sk_pad
// multiples of 64; 1 <= sk_actual <= sk_pad.  D is 128 (K5 at head dim 64
// is fg_flash_fwd_d64).
extern "C" int fg_flash_fwd(const void* qh, const void* kh, const void* vh, void* out, int BN,
                            int sq_pad, int sk_actual, int sk_pad, void* stream) {
  dim3 grid(sq_pad / kTile, BN);
  fa_fwd_kernel<false, kD><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)qh, (const bf16*)kh, (const bf16*)vh, (bf16*)out, nullptr, sq_pad,
      sk_actual, sk_pad);
  return (int)cudaGetLastError();
}

extern "C" int fg_flash_fwd_lse(const void* qh, const void* kh, const void* vh, void* out,
                                void* lse, int BN, int sq_pad, int sk_actual, int sk_pad,
                                void* stream) {
  dim3 grid(sq_pad / kTile, BN);
  fa_fwd_kernel<true, kD><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)qh, (const bf16*)kh, (const bf16*)vh, (bf16*)out, (float*)lse, sq_pad,
      sk_actual, sk_pad);
  return (int)cudaGetLastError();
}
