// fp32 products on Hopper's tensor cores (3xTF32), shared by the fp32 flash
// attention kernels: the forward (K6a at head dim 64, K5 and K4's max and
// masked forms at 8 to 160; csrc/flash_attention_fp32.cu) and K6b / K6c at
// 64 (csrc/flash_attention_fp32_bwd.cu).
//
// wgmma multiplies TF32 (10 mantissa bits).  Each operand x is split as hi =
// rna_tf32(x), lo = rna_tf32(x - hi) (x - hi is exact in fp32), and each
// product A B is taken as lo_A hi_B + hi_A lo_B + hi_A hi_B, three
// m64nNk8.f32.tf32.tf32 passes into one fp32 accumulator: the dropped lo_A
// lo_B and the rounding of lo are below 2^-21 relative.  The tensor cores'
// fp32 sums truncate, so a caller keeps long reductions out of them: it
// starts a fresh accumulator every tile and adds it into registers.
//
// Operands.  For .tf32 wgmma takes no transpose: A and B in shared memory
// are both K-major, in 128-byte-swizzled boxes of 32 fp32 columns (a k-step
// of 8 columns is 32 bytes on; four k-steps a box).  An A operand in
// registers is taken from a wgmma accumulator, whose thread holds columns 2t
// and 2t + 1 of each 8-wide k-step where the TF32 A fragment wants t and t +
// 4; so the B operand of such a product is a transposed copy whose 8 rows
// along the reduced index are permuted as 0, 2, 4, 6, 1, 3, 5, 7
// (permuted_row), which matches the accumulator's order.
#pragma once
#include <stdint.h>

#include "hopper_common.cuh"

namespace hopper {

constexpr int kTf32D = 64;  // the head dim the backward's products reduce over

// ------------------------------------------------------------ TF32 split

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero
// (cvt.rna's rounding), as an fp32 bit pattern with the low 13 bits 0
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// the position of tile row r (0..63) in a transposed tile: each 8 rows as
// 0, 2, 4, 6, 1, 3, 5, 7, so that column p of a permuted 8 holds row
// 2p (p < 4) or 2(p - 4) + 1
__device__ __forceinline__ int permuted_row(int p) {
  const int e = p & 7;
  return (p & ~7) | (e < 4 ? 2 * e : 2 * (e - 4) + 1);
}

// ------------------------------------------------------------ TF32 wgmma

// Each product's first wgmma starts its accumulator (scale-d false) and
// takes it as an output only ("=f"): its old values are dead, so the
// accumulator is not live across the tile loop; the later wgmmas add to it
// ("+f").
#define F8(c, d, i)                                                                       \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), \
      c(d[i + 7])
#define ADD(x) "+f"(x)
#define SET(x) "=f"(x)
#define R32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 64) = [d +] A (64 x 8) B (8 x 64), A and B K-major in shared
// memory; the accumulator layout of wgmma_m64n64k16_ss
template <bool kFirst>
__device__ __forceinline__ void wgmma_n64_ss(float* d, uint64_t da, uint64_t db) {
  if constexpr (kFirst)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
                 ", %32, %33, p, 1, 1;\n}\n"
                 : F8(SET, d, 0), F8(SET, d, 8), F8(SET, d, 16), F8(SET, d, 24)
                 : "l"(da), "l"(db), "r"(0));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
                 ", %32, %33, p, 1, 1;\n}\n"
                 : F8(ADD, d, 0), F8(ADD, d, 8), F8(ADD, d, 16), F8(ADD, d, 24)
                 : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32) = [d +] A (64 x 8) B (8 x 32), both K-major in shared memory
template <bool kFirst>
__device__ __forceinline__ void wgmma_n32_ss(float* d, uint64_t da, uint64_t db) {
  if constexpr (kFirst)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
                 ", %16, %17, p, 1, 1;\n}\n"
                 : F8(SET, d, 0), F8(SET, d, 8)
                 : "l"(da), "l"(db), "r"(0));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
                 ", %16, %17, p, 1, 1;\n}\n"
                 : F8(ADD, d, 0), F8(ADD, d, 8)
                 : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64) = [d +] A (64 x 8, TF32 in registers: a[0] row g col t, a[1]
// row g + 8 col t, a[2] row g col t + 4, a[3] row g + 8 col t + 4, g =
// 16 warp + lane / 4, t = lane % 4) B (8 x 64), B K-major in shared memory
template <bool kFirst>
__device__ __forceinline__ void wgmma_n64_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (kFirst)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : F8(SET, d, 0), F8(SET, d, 8), F8(SET, d, 16), F8(SET, d, 24)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : F8(ADD, d, 0), F8(ADD, d, 8), F8(ADD, d, 16), F8(ADD, d, 24)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) = [d +] A (64 x 8, TF32 in registers, as wgmma_n64_rs) B (8 x
// 32), B K-major in shared memory
template <bool kFirst>
__device__ __forceinline__ void wgmma_n32_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (kFirst)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : F8(SET, d, 0), F8(SET, d, 8)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : F8(ADD, d, 0), F8(ADD, d, 8)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8
#undef ADD
#undef SET
#undef R32
#undef R16

__device__ __forceinline__ uint64_t desc(uint32_t saddr) { return desc_sw128(saddr, 16, 1024); }

// x, opaque to the compiler where it is taken: shared-memory addresses are
// loop invariants, and K6c's 72 wgmma descriptors a tile, hoisted out of
// its loop, would spill; from an opaque base each is made beside its wgmma
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// acc (64 x N) = A B^T over d = 8 KSTEPS (64 unless given) in three passes
// (lo hi, hi lo, hi hi): A's 64 rows and B's N rows K-major (d along the
// row) in 32-column boxes a_box / b_box bytes apart; the lo copies lie lo_a
// / lo_b bytes after the hi ones; k-step ks is 8 columns (32 bytes) on in
// box ks / 4
template <int N, int KSTEPS = kTf32D / 8>
__device__ __forceinline__ void products_over_d(float* acc, uint32_t a, int a_box, int lo_a,
                                                uint32_t b, int b_box, int lo_b) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t pa = a + (pass == 0 ? lo_a : 0), pb = b + (pass == 1 ? lo_b : 0);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint64_t da = desc(pa + (ks / 4) * a_box + (ks % 4) * 32);
      const uint64_t db = desc(pb + (ks / 4) * b_box + (ks % 4) * 32);
      if (pass == 0 && ks == 0) {
        if constexpr (N == 64)
          wgmma_n64_ss<true>(acc, da, db);
        else
          wgmma_n32_ss<true>(acc, da, db);
      } else {
        if constexpr (N == 64)
          wgmma_n64_ss<false>(acc, da, db);
        else
          wgmma_n32_ss<false>(acc, da, db);
      }
    }
  }
}

// acc (64 x N, N = 64 or 32) = A (64 x 8KS, registers: hi and lo
// fragments, 4 a k-step) B (8KS x N), B N rows of a transposed tile (the
// reduced index along the row, permuted within each 8) in 32-column boxes
// `box` bytes apart (8 KB: 64 rows), lo lo_b bytes after hi; three passes
// (lo hi, hi lo, hi hi)
template <int KS, int N = 64>
__device__ __forceinline__ void products_over_rows(float* acc, const uint32_t* hi,
                                                   const uint32_t* lo, uint32_t b, int lo_b,
                                                   int box = 64 * 128) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t* a = pass == 0 ? lo : hi;
    const uint32_t pb = b + (pass == 1 ? lo_b : 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t db = desc(pb + (kk / 4) * box + (kk % 4) * 32);
      if constexpr (N == 64) {
        if (pass == 0 && kk == 0)
          wgmma_n64_rs<true>(acc, a, db);
        else
          wgmma_n64_rs<false>(acc, a + 4 * kk, db);
      } else {
        if (pass == 0 && kk == 0)
          wgmma_n32_rs<true>(acc, a, db);
        else
          wgmma_n32_rs<false>(acc, a + 4 * kk, db);
      }
    }
  }
}

// the 8KS-column accumulator x (wgmma layout) as the TF32 hi and lo A
// fragments of KS k-steps: columns 2t and 2t + 1 of k-step kk go to the
// fragment's columns t and t + 4 (the transposed operand's permutation)
template <int KS>
__device__ __forceinline__ void to_tf32_fragments(const float* x, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    split_tf32(x[4 * kk + 0], hi[4 * kk + 0], lo[4 * kk + 0]);
    split_tf32(x[4 * kk + 2], hi[4 * kk + 1], lo[4 * kk + 1]);
    split_tf32(x[4 * kk + 1], hi[4 * kk + 2], lo[4 * kk + 2]);
    split_tf32(x[4 * kk + 3], hi[4 * kk + 3], lo[4 * kk + 3]);
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

}  // namespace hopper
