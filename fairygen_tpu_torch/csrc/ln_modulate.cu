// K1: LayerNorm -> two-segment AdaLN modulate, bf16 in / bf16 out.
//
// Replaces the TPU kernel fairygen_tpu/ops/fused_norms.py:_ln_mod_kernel
// (entry layer_norm_modulate).  out = (x - mean) * rsqrt(var + eps) *
// (1 + scale[row]) + shift[row], fp32 statistics, where row = 1 for tokens
// with index >= seg and 0 before (the Wan TI2V first-frame segment).
//
// Bound on the H100: bytes.  The work is ~8 flops per element against 4
// bytes moved per element (read x, write out), far below the card's
// ~295 flop/byte ridge, so the floor is 2 * B*S*D * 2 bytes / 3.35 TB/s.
// Design: one warp per token row; the row is read ONCE with 16-byte loads
// into registers, mean and variance are two warp-shuffle reductions over
// those registers, and the modulated row is written with 16-byte stores.
// The (B, 2, D) shift/scale rows are tiny and stay in L1/L2.  A lane holds
// up to kVec 16-byte vectors of its row: 16 for D <= 4096 (the 5B DiT's
// 3072, FLUX.1's 3072), 32 for D <= 8192 (the 14B DiTs' 5120), a template
// argument so that the narrow form keeps its registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNarrowVec = 16;  // 32 lanes * 16 vectors * 8 = 4096 elements
constexpr int kWideVec = 32;    // 32 lanes * 32 vectors * 8 = 8192 elements

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_modulate_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ shift2,
                   const __nv_bfloat16* __restrict__ scale2,
                   __nv_bfloat16* __restrict__ out, int S, int D, int rows,
                   int seg, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;
  const int b = row / S, s = row % S;
  const int nvec = D / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);

  uint4 reg[kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      reg[i] = xr[v];
      float f[8];
      unpack8(reg[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += f[j];
    }
  }
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      float f[8];
      unpack8(reg[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c = f[j] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(sq) / D + eps);

  const int sel = s >= seg ? 1 : 0;
  const uint4* shr = reinterpret_cast<const uint4*>(shift2 + ((size_t)b * 2 + sel) * D);
  const uint4* scr = reinterpret_cast<const uint4*>(scale2 + ((size_t)b * 2 + sel) * D);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      float f[8], sh[8], sc[8], o[8];
      unpack8(reg[i], f);
      unpack8(shr[v], sh);
      unpack8(scr[v], sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = (f[j] - mean) * rstd * (1.f + sc[j]) + sh[j];
      orow[v] = pack8(o);
    }
  }
}

}  // namespace

// x, out: (B, S, D) bf16; shift2, scale2: (B, 2, D) bf16; all contiguous,
// 16-byte aligned, D % 8 == 0 and D <= 8192 (checked by the Python wrapper).
extern "C" int fg_ln_modulate(const void* x, const void* shift2, const void* scale2,
                              void* out, int B, int S, int D, int seg, float eps,
                              void* stream) {
  const int rows = B * S;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (D > 32 * kWideVec * 8) return (int)cudaErrorInvalidValue;
  auto* kernel = D <= 32 * kNarrowVec * 8 ? ln_modulate_kernel<kNarrowVec>
                                          : ln_modulate_kernel<kWideVec>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)shift2,
      (const __nv_bfloat16*)scale2, (__nv_bfloat16*)out, S, D, rows, seg, eps);
  return (int)cudaGetLastError();
}
