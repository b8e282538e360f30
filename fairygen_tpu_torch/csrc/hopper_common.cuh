// Hopper (sm_90a) building blocks of the port's TMA + wgmma kernels (K3 and
// K4's bounded form in flash_attention.cu; K5, K6a and K10 in
// flash_attention_online.cu; K6b and K6c in flash_attention_bwd.cu):
//   - host: bf16 and fp32 tensor maps (128-byte swizzle, or none), encoded
//     through cuTensorMapEncodeTiled, which is reached with
//     cudaGetDriverEntryPointByVersion (CUDA >= 12.5) so that the library
//     needs no -lcuda; the card's SM count;
//   - device: mbarrier init / predicated arrive / arrive with expected
//     bytes / parity wait, TMA tile loads that complete on an mbarrier (and
//     the 1-D bulk copy of K11 in rms_modulate.cu, which needs no map), TMA
//     tile stores in bulk groups, the async-proxy fence and named barriers
//     (a predicated arrival too), the wgmma shared-memory descriptor of a
//     128-byte-swizzled tile, the m64n128k16, m64n80k16 and m64n64k16 bf16
//     products (A from shared memory or from registers; m64n192k16 from
//     registers), wgmma fence / commit /
//     wait, setmaxnreg, and the small arithmetic the attention kernels
//     share (bf16 packing, ex2, the correctly rounded quotient from a
//     reciprocal).
// A 128-byte-swizzled tile holds rows of 64 bf16 (128 bytes); the swizzle
// repeats every 8 rows (1024 bytes), so every tile starts 1024-byte aligned.
#pragma once
#include <cuda.h>  // CUtensorMap and the driver's enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A tensor map of `rank` dims (innermost first; `strides` in bytes for dims
// 1..rank-1), `box` elements a dim, 128-byte swizzle unless `swizzle` says
// otherwise (a swizzled box row holds at most 128 bytes); a box that
// reaches past a dim reads zeros there.  Returns a cudaError_t value.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
                  elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int make_map_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box);
}

// the card's SM count, read once (0 when it cannot be read)
inline int sm_count() {
  static int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init, before any other thread uses the barriers
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// an arrival by the threads whose `pred` is non-zero, predicated inside the
// asm so that no branch sits between a wgmma's issue and its wait
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, int pred) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "setp.ne.b32 P1, %1, 0;\n"
      "@P1 mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(pred)
      : "memory");
}

// one arrival that also expects `bytes` more of asynchronous (TMA) traffic
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first as completed: parity 1 passes at once).
// The loop stays inside the asm: a loop the compiler can see between a
// wgmma's issue and its wait makes ptxas serialize the wgmmas.  A phase that
// never completes is a bug: after 2^26 tries (each may suspend the thread a
// while, so seconds) the kernel traps, and the next synchronisation reports
// the error, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      ".reg .u32 N;\n"
      "mov.u32 N, 0;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "add.u32 N, N, 1;\n"
      "setp.lt.u32 P1, N, 67108864;\n"
      "@P1 bra LAB_WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA tile loads into shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// a 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, counted in bytes on `bar`: no
// tensor map, so nothing is encoded on the host (K11's row tiles)
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TMA tile store from shared memory (a box that reaches past a dim writes
// nothing there), in bulk groups the issuing thread commits and waits for
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// until the committed stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy shared-memory writes made visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// an arrival (no wait) on barrier `id` by the threads whose `pred` is
// non-zero, predicated inside the asm like mbar_arrive_if
__device__ __forceinline__ void named_bar_arrive_if(int id, int threads, int pred) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "setp.ne.b32 P1, %2, 0;\n"
      "@P1 bar.arrive %0, %1;\n"
      "}\n" ::"r"(id),
      "r"(threads), "r"(pred)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address `saddr`.
// K-major (rows of 64 bf16 along K): sbo = 1024 (8 rows), lbo unused (16).
// MN-major: lbo = the distance between 64-wide MN blocks, sbo = 1024 (8 K
// rows of 128 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving a register that an in-flight wgmma owns
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
template <int kN, typename T>
__device__ __forceinline__ void fence_regs(T* r) {
#pragma unroll
  for (int i = 0; i < kN; ++i) fence_reg(r[i]);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

#define HP_D8(d, i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HP_D64(d)                                                                          \
  HP_D8(d, 0), HP_D8(d, 8), HP_D8(d, 16), HP_D8(d, 24), HP_D8(d, 32), HP_D8(d, 40), \
      HP_D8(d, 48), HP_D8(d, 56)
#define HP_D32(d) HP_D8(d, 0), HP_D8(d, 8), HP_D8(d, 16), HP_D8(d, 24)
#define HP_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) = [d +] A (64 x 16) · B (16 x 128); A and B K-major in
// shared memory.  Accumulator layout: warp w of the warpgroup holds rows
// 16w + g and 16w + g + 8 (g = lane / 4); d[4j + {0,1}] are row 16w + g,
// columns 8j + 2(lane % 4) + {0,1}; d[4j + {2,3}] the same columns of row
// 16w + g + 8.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HP_R64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HP_D64(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) = [d +] A (64 x 16) · B (16 x 64); A and B K-major in
// shared memory: the m64n128k16 form's accumulator layout for j < 8
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HP_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 80, fp32) = [d +] A (64 x 16) · B (16 x 80); A and B K-major in
// shared memory: the m64n128k16 form's accumulator layout for j < 10
__device__ __forceinline__ void wgmma_m64n80k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}"
      ", %40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      : HP_D32(d), HP_D8(d, 32)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 in registers: the m16n8k16 A
// fragment of each warp's 16 rows) · B (16 x 128), B MN-major in shared
// memory (the transposed-B form).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float* d, const uint32_t* a,
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HP_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HP_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) · B (16 x 64), B
// MN-major in shared memory (one 64-wide block): the m64n128k16 form's
// accumulator layout, columns 8j + 2(lane % 4) + {0,1} for j < 8
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float* d, const uint32_t* a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HP_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 192, fp32) += A (64 x 16, bf16 in registers) · B (16 x 192), B
// MN-major in shared memory (three 64-wide blocks): the m64n128k16 form's
// accumulator layout, columns 8j + 2(lane % 4) + {0,1} for j < 24
__device__ __forceinline__ void wgmma_m64n192k16_rs_tb(float* d, const uint32_t* a,
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : HP_D64(d), HP_D32((d + 64))
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HP_D8
#undef HP_D32
#undef HP_D64
#undef HP_R64

// ------------------------------------------------- attention arithmetic

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------- attention tiles of 128 q rows x 128 keys
// Q (two consumer warpgroups of 64 rows), K and V tiles are 128 rows of D
// bf16, 128-byte swizzled, in 64-column boxes of 128 rows (16 KB) each.

// S (64 x N keys; N = 128, or the first 80 keys of the tile) = the Q rows
// of one warpgroup · K^T: D/16 k-steps of 16, four in each 64-column box
// (32 bytes apart in a 128-byte row); at D = 160 the third box's first two
// k-steps only (its last 32 columns, zeros, are not read)
template <int D, int N = 128>
__device__ __forceinline__ void tile_scores(float* s, uint32_t q_base, uint32_t k_base) {
  static_assert(N == 128 || N == 80, "S is 128 or 80 keys wide");
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / 4) * (128 * 128) + (ks % 4) * 32;
    const uint64_t da = desc_sw128(q_base + off, 16, 1024);
    const uint64_t db = desc_sw128(k_base + off, 16, 1024);
    if constexpr (N == 128)
      wgmma_m64n128k16_ss(s, da, db, ks > 0);
    else
      wgmma_m64n80k16_ss(s, da, db, ks > 0);
  }
}

// O (64 x W) += P (64 x 16KS keys, registers; 128 by default) · V (16KS
// keys x W): the 16 keys of k-step ks are 16 rows (2048 bytes) on; V's
// 64-column boxes are 16 KB apart (the MN-block stride); m64n192k16 at W =
// 192, m64n128k16 at 128, m64n64k16 at 64
template <int W, int KS = 8>
__device__ __forceinline__ void tile_pv(float* o, const uint32_t* p, uint32_t v_base) {
  static_assert(W == 64 || W == 128 || W == 192, "O is 64, 128 or 192 columns wide");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t desc = desc_sw128(v_base + ks * 2048, 128 * 128, 1024);
    if constexpr (W == 192)
      wgmma_m64n192k16_rs_tb(o, p + 4 * ks, desc);
    else if constexpr (W == 128)
      wgmma_m64n128k16_rs_tb(o, p + 4 * ks, desc);
    else
      wgmma_m64n64k16_rs_tb(o, p + 4 * ks, desc);
  }
}

// a 64 x 16KS S accumulator (wgmma layout; 64 x 128 by default) as the
// bf16 A fragments of the KS k-steps of P V
template <int KS = 8>
__device__ __forceinline__ void to_a_fragments(const float* s, uint32_t* p) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// o / d correctly rounded in fp32, as __fdiv_rn gives it, from inv = 1 / d
// correctly rounded: the residual o - q d is exact in an fma, and one
// correction of q = o * inv with it rounds to the nearest quotient
// (Markstein's theorem; the row sum d and o lie far from over- and
// underflow).  Two fmas an element in place of __fdiv_rn's range checks.
__device__ __forceinline__ float div_rn(float o, float d, float inv) {
  const float q = __fmul_rn(o, inv);
  return __fmaf_rn(__fmaf_rn(-q, d, o), inv, q);
}

}  // namespace hopper
