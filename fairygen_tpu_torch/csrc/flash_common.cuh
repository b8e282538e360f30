// The mma.sync helpers of flash_small_kv.cu (K4's max and masked forms):
// tile sizes, the m16n8k16 bf16 product, fragment loads and the
// shared-memory tile stagers, which take the head dim D as a template
// argument.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // rows per CTA and rows per loop tile
constexpr int kThreads = 128;        // 4 warps x 16 rows
constexpr int kTStride = kTile + 8;  // bf16 per row of a transposed smem tile

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

// bf16 per row of a row-major smem tile of head dim D
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// A fragments (16 rows x 16 of d, KS = D / 16 steps over d) of rows p[0..16)
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* p, int stride, int g,
                                       int tg) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
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

// 64 rows of a (rows, D) matrix -> smem [64][row_stride<D>()]
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < kTile * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    *reinterpret_cast<uint4*>(dst + r * row_stride<D>() + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c * 8);
  }
}

// 64 rows of a (rows, D) matrix -> transposed smem [D][kTStride];
// consecutive threads take consecutive rows, so the 2-byte stores of a
// warp land on consecutive smem words
template <int D>
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < kTile * (D / 8); i += kThreads) {
    const int r = i % kTile, c = i / kTile;
    uint4 val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * kTStride + r] = e[j];
  }
}

// S = Q K^T for one 64-key tile staged row-major in Ks: s[nt] holds keys
// nt * 8 + 2 * tg + {0, 1} of the rows g (s[nt][0..1]) and g + 8 (s[nt][2..3])
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], uint32_t (&qa)[D / 16][4],
                                            const bf16* Ks, int g, int tg) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* kp = Ks + (nt * 8 + g) * row_stride<D>() + ks * 16 + tg * 2;
      mma_bf16(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
    }
  }
}

// O += P V for one 64-key tile: P is s rounded to bf16 (the accumulators
// become A fragments without a shuffle), V is staged transposed in Vt
template <int D>
__device__ __forceinline__ void tile_pv(float (&o)[D / 8][4], const float (&s)[8][4],
                                        const bf16* Vt, int g, int tg) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const bf16* vp = Vt + (dt * 8 + g) * kTStride + kk * 16 + tg * 2;
      mma_bf16(o[dt], pa, ld32(vp), ld32(vp + 8));
    }
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

}  // namespace
