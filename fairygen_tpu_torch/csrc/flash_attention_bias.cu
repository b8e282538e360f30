// K10: flash attention with a head-shared additive logits bias (the EliGen
// regional masks of the FLUX.1 DiT), on head-major bf16 q/k/v.
//
// Replaces the TPU kernel fairygen_tpu/ops/flash_attention.py:_fa_bias_kernel
// (entry flash_attention_bias).  Contract: q carries hd^-1/2 * log2(e); the
// bias is fp32 (B|1, sq, sk) in the natural-log domain (the attn_mask of
// scaled_dot_product_attention) and is shared by the heads: a CTA of head
// bn reads bias row bn / N (row 0 when the bias has one batch row).
//   s = q.k + bias * log2(e);  online softmax in base 2 with a running max;
//   o = sum_j exp2(s_j - m) v_j / l.
// Query rows >= sq and key columns >= sk take the bias -1e30, as the TPU
// kernel's padded bias does: a padded key adds exp2(-1.44e30 - m) = 0, and a
// padded query row (all -1e30) stays finite.  Not -inf for that reason.
//
// Bound on the H100: operations (4 * Sq * Sk * 128 flops per head).  The
// bias is the largest input (127 MB at FLUX.1's 5632 EliGen tokens, more
// than the 50 MB L2): read from DRAM once per head it would cost 24x its
// size.  Design: K5's loop (csrc/flash_attention_train.cu) — a CTA owns 64
// query rows of one head, q stays in registers as mma A fragments, K
// (row-major) and V (transposed) tiles of 64 keys are staged in padded
// shared memory, mma.sync.m16n8k16 bf16 with fp32 accumulation — plus the
// bias tile, read straight from global memory into the score fragments
// before the running max.  The grid puts the heads on blockIdx.x, so the
// CTAs resident together are the 24 heads of a few query tiles and share
// those tiles' bias rows in L2 (64 rows x sk x 4 B each).  The loop stops at
// the last tile holding a real key.  No TMA / wgmma / pipelining yet.
#include "flash_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadBias = -1e30f;

__global__ void __launch_bounds__(kThreads)
fa_bias_kernel(const bf16* __restrict__ qh, const bf16* __restrict__ kh,
               const bf16* __restrict__ vh, const float* __restrict__ bias,
               bf16* __restrict__ out, int N, int bias_rows, int sq, int sq_pad, int sk,
               int sk_pad) {
  __shared__ __align__(16) bf16 Ks[kRowTile];
  __shared__ __align__(16) bf16 Vt[kTTile];
  const int bn = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* bb = bias + (size_t)(bias_rows == 1 ? 0 : bn / N) * sq * sk;
  const float* b0 = r0 < sq ? bb + (size_t)r0 * sk : nullptr;
  const float* b1 = r1 < sq ? bb + (size_t)r1 * sk : nullptr;

  uint32_t qa[8][4];
  load_a(qa, qh + ((size_t)bn * sq_pad + q0 + warp * 16) * kD, kD, g, tg);
  float o[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const bf16* kb = kh + (size_t)bn * sk_pad * kD;
  const bf16* vb = vh + (size_t)bn * sk_pad * kD;
  for (int k0 = 0; k0 < sk; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_rows(Ks, kb + (size_t)k0 * kD);
    load_rows_t(Vt, vb + (size_t)k0 * kD);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const bf16* kp = Ks + (nt * 8 + g) * kRowStride + ks * 16 + tg * 2;
        mma_bf16(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + tg * 2 + (i & 1);
        const float* br = i < 2 ? b0 : b1;
        const float bv = (br != nullptr && col < sk) ? __ldg(br + col) : kPadBias;
        s[nt][i] = __fadd_rn(s[nt][i], __fmul_rn(bv, kLog2e));
      }
    // every score is finite (>= -1.44e30 - |q.k|), so the new max is finite
    // and the first tile's rescale is exp2(-inf) = 0
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
    for (int dt = 0; dt < 16; ++dt) {
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        const bf16* vp = Vt + (dt * 8 + g) * kTStride + kk * 16 + tg * 2;
        mma_bf16(o[dt], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t o0 = (size_t)bn * sq_pad + r0, o1 = o0 + 8;
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int col = dt * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(out + o0 * kD + col) =
        pack_bf16(__fdiv_rn(o[dt][0], l0), __fdiv_rn(o[dt][1], l0));
    *reinterpret_cast<uint32_t*>(out + o1 * kD + col) =
        pack_bf16(__fdiv_rn(o[dt][2], l1), __fdiv_rn(o[dt][3], l1));
  }
}

}  // namespace

// qh, out: (BN, sq_pad, 128) bf16; kh, vh: (BN, sk_pad, 128) bf16, zero rows
// past sk; bias: (bias_rows, sq, sk) fp32 contiguous with bias_rows 1 or
// BN / N; sq_pad and sk_pad multiples of 64, 1 <= sq <= sq_pad, 1 <= sk <=
// sk_pad (checked by the Python wrapper).
extern "C" int fg_flash_bias(const void* qh, const void* kh, const void* vh, const void* bias,
                             void* out, int BN, int N, int bias_rows, int sq, int sq_pad, int sk,
                             int sk_pad, void* stream) {
  dim3 grid(BN, sq_pad / kTile);
  fa_bias_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)qh, (const bf16*)kh, (const bf16*)vh, (const float*)bias, (bf16*)out, N,
      bias_rows, sq, sq_pad, sk, sk_pad);
  return (int)cudaGetLastError();
}
