// Shared by the mma.sync flash kernels (flash_attention_train.cu, K5/K6a-c,
// and flash_attention_bias.cu, K10): tile sizes, the m16n8k16 bf16 product,
// fragment loads and the shared-memory tile stagers.  Head dim 128.
#pragma once
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

}  // namespace
