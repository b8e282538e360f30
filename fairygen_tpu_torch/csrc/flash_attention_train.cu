// K5, K6a, K6b, K6c: the generic flash attention with a running max, its
// LSE-emitting forward, and the two backward kernels, on head-major bf16
// q/k/v (B*N, S_pad, 128).
//
// Replaces the TPU kernels fairygen_tpu/ops/flash_attention.py:
//   K5  _fa_kernel          forward, online softmax (no-grad generic entry)
//   K6a _fa_fwd_lse_kernel  the same plus the per-row base-2 logsumexp
//   K6b _fa_bwd_dq_kernel   dQ = f * sum_j [P o (dP - delta)] K_j
//   K6c _fa_bwd_dkv_kernel  dV = sum_i P^T dO_i, dK = sum_i [P o (dP - delta)]^T Q_i / log2(e)
// Contract (the JAX package's): q carries scale * log2(e), so P =
// exp2(s - m); key columns >= sk_actual are masked (P = 0 exactly, as
// exp2(-inf)); lse = m + log2(l) is one fp32 value per row (the TPU's
// 128-lane broadcast is a layout artefact and is not kept); delta =
// sum_d dO * O is one fp32 value per row, computed by the caller.
//
// Bound on the H100: operations.  4 (K5/K6a), 6 (K6b) and 8 (K6c) *
// Sq * Sk * 128 flops per head against a few bytes per row, far above the
// ridge.  Design, as K3 (csrc/flash_attention.cu): a CTA owns 64 rows
// (4 warps x 16), the TPU's sequential grid axis becomes a loop over
// 64-row tiles inside the CTA, tiles are staged in padded shared memory
// (row-major for the operand read along d, transposed for the operand read
// along the tile), and every product runs on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  The accumulators of one
// product become the A fragments of the next without a shuffle.  The two
// backward kernels keep the TPU design's split: K6b owns q rows and loops
// over key tiles, K6c owns key rows and loops over q tiles.  Neither uses
// atomics, so every gradient is deterministic from run to run.  Loops stop
// at the last tile holding a valid key (K5/K6a/K6b) or query (K6c): tiles
// past it contribute exact zeros.  To keep K6c free of spills, its K and V
// fragments are re-read from shared memory and the score tile is handled
// 16 queries at a time; only the dK and dV accumulators live in registers.
// No TMA / wgmma / pipelining yet: these are the first, simple kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kTile = 64;            // rows per CTA and rows per loop tile
constexpr int kThreads = 128;        // 4 warps x 16 rows
constexpr int kRowStride = kD + 8;   // bf16 per row of a row-major smem tile
constexpr int kTStride = kTile + 8;  // bf16 per row of a transposed smem tile
constexpr int kRowTile = kTile * kRowStride;
constexpr int kTTile = kD * kTStride;
constexpr float kInvLog2e = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments (16 rows x 16 of d, 8 steps over d = 128) of rows p[0..16)
__device__ __forceinline__ void load_a(uint32_t (&a)[8][4], const bf16* p, int stride, int g,
                                       int tg) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    a[ks][0] = ld32(p + g * stride + ks * 16 + tg * 2);
    a[ks][1] = ld32(p + (g + 8) * stride + ks * 16 + tg * 2);
    a[ks][2] = ld32(p + g * stride + ks * 16 + 8 + tg * 2);
    a[ks][3] = ld32(p + (g + 8) * stride + ks * 16 + 8 + tg * 2);
  }
}

// the accumulators of two 8-column n tiles -> one 16-deep A fragment
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 64 rows of a (rows, 128) matrix -> smem [64][kRowStride]
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = i % (kD / 8);
    *reinterpret_cast<uint4*>(dst + r * kRowStride + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * kD + c * 8);
  }
}

// 64 rows of a (rows, 128) matrix -> transposed smem [128][kTStride];
// consecutive threads take consecutive rows, so the 2-byte stores of a
// warp land on consecutive smem words
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThreads) {
    const int r = i % kTile, c = i / kTile;
    uint4 val = *reinterpret_cast<const uint4*>(src + (size_t)r * kD + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * kTStride + r] = e[j];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K5 (kLse = false) and K6a (kLse = true)
template <bool kLse>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const bf16* __restrict__ qh, const bf16* __restrict__ kh,
              const bf16* __restrict__ vh, bf16* __restrict__ out, float* __restrict__ lse,
              int sq_pad, int sk_actual, int sk_pad) {
  __shared__ __align__(16) bf16 Ks[kRowTile];
  __shared__ __align__(16) bf16 Vt[kTTile];
  const int bn = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;

  uint32_t qa[8][4];
  load_a(qa, qh + ((size_t)bn * sq_pad + q0 + warp * 16) * kD, kD, g, tg);
  float o[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const bf16* kb = kh + (size_t)bn * sk_pad * kD;
  const bf16* vb = vh + (size_t)bn * sk_pad * kD;
  for (int k0 = 0; k0 < sk_actual; k0 += kTile) {
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
  const size_t r0 = (size_t)bn * sq_pad + q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int col = dt * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(out + r0 * kD + col) =
        pack_bf16(__fdiv_rn(o[dt][0], l0), __fdiv_rn(o[dt][1], l0));
    *reinterpret_cast<uint32_t*>(out + r1 * kD + col) =
        pack_bf16(__fdiv_rn(o[dt][2], l1), __fdiv_rn(o[dt][3], l1));
  }
  if (kLse && tg == 0) {
    lse[r0] = m0 + log2f(l0);
    lse[r1] = m1 + log2f(l1);
  }
}

// K6b: one CTA per (head, 64 q rows); q and dO stay in registers as A
// fragments; per key tile K (row-major and transposed) and V (row-major)
// are staged, and the tile is consumed 16 keys at a time.
constexpr int kDqSmem = (2 * kRowTile + kTTile) * 2;

__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const bf16* __restrict__ qh, const bf16* __restrict__ kh,
                 const bf16* __restrict__ vh, const bf16* __restrict__ doh,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, float dq_factor, int sq_pad, int sk_actual,
                 int sk_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRowTile;
  bf16* Kt = Vs + kRowTile;
  const int bn = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;

  const size_t row = (size_t)bn * sq_pad + q0 + warp * 16;
  uint32_t qa[8][4], da[8][4];
  load_a(qa, qh + row * kD, kD, g, tg);
  load_a(da, doh + row * kD, kD, g, tg);
  const float lse0 = lse[row + g], lse1 = lse[row + g + 8];
  const float dl0 = delta[row + g], dl1 = delta[row + g + 8];
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const bf16* kb = kh + (size_t)bn * sk_pad * kD;
  const bf16* vb = vh + (size_t)bn * sk_pad * kD;
  for (int k0 = 0; k0 < sk_actual; k0 += kTile) {
    __syncthreads();
    load_rows(Ks, kb + (size_t)k0 * kD);
    load_rows(Vs, vb + (size_t)k0 * kD);
    load_rows_t(Kt, kb + (size_t)k0 * kD);
    __syncthreads();
    const bool edge = k0 + kTile > sk_actual;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
        const int off = ((2 * kk + h) * 8 + g) * kRowStride + tg * 2;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          mma_bf16(s[h], qa[ks], ld32(Ks + off + ks * 16), ld32(Ks + off + ks * 16 + 8));
          mma_bf16(dp[h], da[ks], ld32(Vs + off + ks * 16), ld32(Vs + off + ks * 16 + 8));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[h][i];
          if (edge && k0 + (2 * kk + h) * 8 + tg * 2 + (i & 1) >= sk_actual) x = -INFINITY;
          const float p = exp2f(x - (i < 2 ? lse0 : lse1));
          s[h][i] = p * (dp[h][i] - (i < 2 ? dl0 : dl1));
        }
      uint32_t a[4];
      to_a(a, s[0], s[1]);
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        const bf16* kp = Kt + (dt * 8 + g) * kTStride + kk * 16 + tg * 2;
        mma_bf16(acc[dt], a, ld32(kp), ld32(kp + 8));
      }
    }
  }

  const size_t r0 = row + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int col = dt * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(dq + r0 * kD + col) =
        pack_bf16(acc[dt][0] * dq_factor, acc[dt][1] * dq_factor);
    *reinterpret_cast<uint32_t*>(dq + r1 * kD + col) =
        pack_bf16(acc[dt][2] * dq_factor, acc[dt][3] * dq_factor);
  }
}

// K6c: one CTA per (head, 64 key rows); this CTA's K and V stay in shared
// memory; per q tile, Q and dO are staged row-major and transposed with
// their lse and delta, and the tile is consumed 16 queries at a time.
// Queries >= sq (zero padding) are skipped or masked here, whatever the
// padded rows of dO hold.
constexpr int kDkvSmem = (4 * kRowTile + 2 * kTTile) * 2 + 2 * kTile * 4;

__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const bf16* __restrict__ qh, const bf16* __restrict__ kh,
                  const bf16* __restrict__ vh, const bf16* __restrict__ doh,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sq_pad,
                  int sk_actual, int sk_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRowTile;
  bf16* Qs = Vs + kRowTile;
  bf16* Ds = Qs + kRowTile;
  bf16* Qt = Ds + kRowTile;
  bf16* Dt = Qt + kTTile;
  float* lse_s = reinterpret_cast<float*>(Dt + kTTile);
  float* dl_s = lse_s + kTile;
  const int bn = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;

  load_rows(Ks, kh + ((size_t)bn * sk_pad + k0) * kD);
  load_rows(Vs, vh + ((size_t)bn * sk_pad + k0) * kD);
  const bool ok0 = k0 + warp * 16 + g < sk_actual, ok1 = k0 + warp * 16 + g + 8 < sk_actual;
  const bf16* ka_p = Ks + warp * 16 * kRowStride;
  const bf16* va_p = Vs + warp * 16 * kRowStride;
  float dka[16][4], dva[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  const bf16* qb = qh + (size_t)bn * sq_pad * kD;
  const bf16* db = doh + (size_t)bn * sq_pad * kD;
  for (int i0 = 0; i0 < sq; i0 += kTile) {
    __syncthreads();
    load_rows(Qs, qb + (size_t)i0 * kD);
    load_rows(Ds, db + (size_t)i0 * kD);
    load_rows_t(Qt, qb + (size_t)i0 * kD);
    load_rows_t(Dt, db + (size_t)i0 * kD);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[(size_t)bn * sq_pad + i0 + threadIdx.x];
      dl_s[threadIdx.x] = delta[(size_t)bn * sq_pad + i0 + threadIdx.x];
    }
    __syncthreads();
    const bool edge = i0 + kTile > sq;
    // one 16-query chunk at a time: unrolling this loop lets the compiler
    // overlap chunks and spill
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t ka[4], va[4];
        const int ao = g * kRowStride + ks * 16 + tg * 2;
        ka[0] = ld32(ka_p + ao);
        ka[1] = ld32(ka_p + ao + 8 * kRowStride);
        ka[2] = ld32(ka_p + ao + 8);
        ka[3] = ld32(ka_p + ao + 8 * kRowStride + 8);
        va[0] = ld32(va_p + ao);
        va[1] = ld32(va_p + ao + 8 * kRowStride);
        va[2] = ld32(va_p + ao + 8);
        va[3] = ld32(va_p + ao + 8 * kRowStride + 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bo = ((2 * kk + h) * 8 + g) * kRowStride + ks * 16 + tg * 2;
          mma_bf16(s[h], ka, ld32(Qs + bo), ld32(Qs + bo + 8));
          mma_bf16(dp[h], va, ld32(Ds + bo), ld32(Ds + bo + 8));
        }
      }
      // rows are keys, columns queries: P^T and dS^T of 16 queries
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = (2 * kk + h) * 8 + tg * 2 + (i & 1);
          float x = s[h][i];
          if (!(i < 2 ? ok0 : ok1) || (edge && i0 + col >= sq)) x = -INFINITY;
          const float p = exp2f(x - lse_s[col]);
          s[h][i] = p;
          dp[h][i] = p * (dp[h][i] - dl_s[col]);
        }
      uint32_t pa[4], dsa[4];
      to_a(pa, s[0], s[1]);
      to_a(dsa, dp[0], dp[1]);
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        const int bo = (dt * 8 + g) * kTStride + kk * 16 + tg * 2;
        mma_bf16(dva[dt], pa, ld32(Dt + bo), ld32(Dt + bo + 8));
        mma_bf16(dka[dt], dsa, ld32(Qt + bo), ld32(Qt + bo + 8));
      }
    }
  }

  const size_t r0 = (size_t)bn * sk_pad + k0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int col = dt * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(dk + r0 * kD + col) =
        pack_bf16(dka[dt][0] * kInvLog2e, dka[dt][1] * kInvLog2e);
    *reinterpret_cast<uint32_t*>(dk + r1 * kD + col) =
        pack_bf16(dka[dt][2] * kInvLog2e, dka[dt][3] * kInvLog2e);
    *reinterpret_cast<uint32_t*>(dv + r0 * kD + col) = pack_bf16(dva[dt][0], dva[dt][1]);
    *reinterpret_cast<uint32_t*>(dv + r1 * kD + col) = pack_bf16(dva[dt][2], dva[dt][3]);
  }
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Shapes (checked by the Python wrappers): qh, doh, out, dq (BN, sq_pad,
// 128) bf16; kh, vh, dk, dv (BN, sk_pad, 128) bf16; lse, delta (BN, sq_pad)
// fp32; sq_pad and sk_pad multiples of 64; 1 <= sk_actual <= sk_pad and
// sq <= sq_pad.
extern "C" int fg_flash_fwd(const void* qh, const void* kh, const void* vh, void* out, int BN,
                            int sq_pad, int sk_actual, int sk_pad, void* stream) {
  dim3 grid(sq_pad / kTile, BN);
  fa_fwd_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)qh, (const bf16*)kh, (const bf16*)vh, (bf16*)out, nullptr, sq_pad, sk_actual,
      sk_pad);
  return (int)cudaGetLastError();
}

extern "C" int fg_flash_fwd_lse(const void* qh, const void* kh, const void* vh, void* out,
                                void* lse, int BN, int sq_pad, int sk_actual, int sk_pad,
                                void* stream) {
  dim3 grid(sq_pad / kTile, BN);
  fa_fwd_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)qh, (const bf16*)kh, (const bf16*)vh, (bf16*)out, (float*)lse, sq_pad,
      sk_actual, sk_pad);
  return (int)cudaGetLastError();
}

extern "C" int fg_flash_bwd_dq(const void* qh, const void* kh, const void* vh, const void* doh,
                               const void* lse, const void* delta, void* dq, float dq_factor,
                               int BN, int sq_pad, int sk_actual, int sk_pad, void* stream) {
  static int attr = allow_smem(fa_bwd_dq_kernel, kDqSmem);
  if (attr) return attr;
  dim3 grid(sq_pad / kTile, BN);
  fa_bwd_dq_kernel<<<grid, kThreads, kDqSmem, (cudaStream_t)stream>>>(
      (const bf16*)qh, (const bf16*)kh, (const bf16*)vh, (const bf16*)doh, (const float*)lse,
      (const float*)delta, (bf16*)dq, dq_factor, sq_pad, sk_actual, sk_pad);
  return (int)cudaGetLastError();
}

extern "C" int fg_flash_bwd_dkv(const void* qh, const void* kh, const void* vh, const void* doh,
                                const void* lse, const void* delta, void* dk, void* dv, int BN,
                                int sq, int sq_pad, int sk_actual, int sk_pad, void* stream) {
  static int attr = allow_smem(fa_bwd_dkv_kernel, kDkvSmem);
  if (attr) return attr;
  dim3 grid(sk_pad / kTile, BN);
  fa_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, (cudaStream_t)stream>>>(
      (const bf16*)qh, (const bf16*)kh, (const bf16*)vh, (const bf16*)doh, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, sq, sq_pad, sk_actual, sk_pad);
  return (int)cudaGetLastError();
}
