// K2: rms-apply -> adjacent-pair RoPE -> head-major store, bf16; and K7 /
// K8, the per-head-rms forms of the image DiTs (after K2, below).
//
// Replaces the TPU kernel fairygen_tpu/ops/fused_qk.py:_prep_kernel (entry
// rms_rope_heads_major).  For token s < S and head n:
//   y = bf16(x * rowscale[s]) * gamma           (the ops/norms.rms_norm order)
//   out[j] = y[j] * cos_full[s, j] + y[j ^ 1] * sin_sign[s, j]    (rope)
// written to out[(b*N + n), s, :]; rows s >= S are written as exact zeros
// (the bounded flash kernels' l -= pad contract relies on it).
//
// Bound on the H100: bytes.  Each element is read once (2 B) and written
// once (2 B) with a handful of flops, so the floor is the x read + the
// head-major write (+ the fp32 tables, re-read per head from L2) over
// 3.35 TB/s.  Design: one thread owns 8 lanes (4 rotation pairs) of one
// (token, head) row, so the pair swap stays inside a thread's registers;
// 16 consecutive threads cover a 128-wide head row and the head-major
// store is fully coalesced.  The rounding steps use explicit _rn
// intrinsics so the kernel reproduces the plain PyTorch version bit for
// bit (no FMA contraction).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;
constexpr int kChunks = kHd / 8;  // threads per (token, head) row
constexpr int kThreads = 256;

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <bool kRope>
__global__ void __launch_bounds__(kThreads)
rms_rope_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ rowscale,
                const __nv_bfloat16* __restrict__ gamma, const float* __restrict__ cosf,
                const float* __restrict__ sinf, __nv_bfloat16* __restrict__ out, int S,
                int N, int s_pad, long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int chunk = (int)(t % kChunks);
  const long long orow = t / kChunks;  // (b*N + n) * s_pad + s
  const int s = (int)(orow % s_pad);
  const long long bn = orow / s_pad;
  const int n = (int)(bn % N);
  const long long b = bn / N;

  uint4 res = make_uint4(0u, 0u, 0u, 0u);
  if (s < S) {
    const long long xrow = b * S + s;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + xrow * (long long)(N * kHd) +
                                                     n * kHd + chunk * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(gamma + n * kHd + chunk * 8);
    const float rs = rowscale[xrow];
    float xf[8], gf[8], y[8], r[8];
    unpack8(xv, xf);
    unpack8(gv, gf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float yb = __bfloat162float(__float2bfloat16_rn(__fmul_rn(xf[j], rs)));
      y[j] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(yb, gf[j])));
    }
    if (kRope) {
      const float4* cp = reinterpret_cast<const float4*>(cosf + (long long)s * kHd + chunk * 8);
      const float4* sp = reinterpret_cast<const float4*>(sinf + (long long)s * kHd + chunk * 8);
      const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float e = y[2 * p], o = y[2 * p + 1];
        r[2 * p] = __fadd_rn(__fmul_rn(e, c[2 * p]), __fmul_rn(o, sn[2 * p]));
        r[2 * p + 1] = __fadd_rn(__fmul_rn(o, c[2 * p + 1]), __fmul_rn(e, sn[2 * p + 1]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = y[j];
    }
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(out + orow * kHd + chunk * 8) = res;
}

// K7 / K8: per-head rms + interleaved RoPE + head-major store.
//
// Replace fairygen_tpu/ops/fused_qk.py:_prep_kernel_per_head (K7, entry
// rms_rope_heads_major_per_head) and _prep_kernel_joint (K8, entry
// rms_rope_heads_major_joint).  For output row s of head n:
//   rows [0, i_pad) come from stream A (row s), rows [i_pad, s_pad) from
//   stream B (row s - i_pad); a row past its stream's length is stored as
//   exact zeros (the gap and tail rows the bounded flash kernels' count
//   correction relies on);
//   rs = 1 / sqrt(sum(x^2) / 128 + eps) over the head's 128 lanes, fp32;
//   y = bf16(bf16(x * rs) * gamma)       (gamma (128,) of the stream)
//   out[j] = y[j] * cos_full[s, j] + y[j ^ 1] * sin_sign[s, j]
// with one table in output-row order.  K7 is the one-stream case (i_pad =
// s_pad).  Bound: bytes, as K2 (one read and one write of each element).
// Design: K2's (8 lanes a thread, 16 threads a head row) layout; the head's
// sum of squares is a 16-lane butterfly of __shfl_xor_sync inside the
// half-warp that owns the row, so the statistic needs no second pass and no
// shared memory.  Every thread of a warp reaches the shuffles (out-of-range
// threads carry zeros and store nothing).  Inputs are rows of a fused
// projection output: a row stride (elements) is passed per stream.
__global__ void __launch_bounds__(kThreads)
rms_rope_per_head_kernel(const __nv_bfloat16* __restrict__ xa, long long stride_a,
                         const __nv_bfloat16* __restrict__ xb, long long stride_b,
                         const __nv_bfloat16* __restrict__ ga,
                         const __nv_bfloat16* __restrict__ gb, const float* __restrict__ cosf,
                         const float* __restrict__ sinf, __nv_bfloat16* __restrict__ out,
                         int S_a, int S_b, int N, int i_pad, int s_pad, float eps,
                         long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = t < total;
  const int chunk = (int)(t % kChunks);
  const long long orow = t / kChunks;  // (b*N + n) * s_pad + s
  const int s = (int)(orow % s_pad);
  const long long bn = orow / s_pad;
  const int n = (int)(bn % N);
  const long long b = bn / N;

  const bool second = s >= i_pad;
  const int row = second ? s - i_pad : s;
  const bool valid = in_range && row < (second ? S_b : S_a);
  float xf[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) xf[j] = 0.f;
  if (valid) {
    const __nv_bfloat16* src = second ? xb + (b * S_b + row) * stride_b
                                      : xa + (b * S_a + row) * stride_a;
    unpack8(*reinterpret_cast<const uint4*>(src + n * kHd + chunk * 8), xf);
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(xf[j], xf[j]));
#pragma unroll
  for (int m = 1; m < kChunks; m <<= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, m));
  if (!in_range) return;

  uint4 res = make_uint4(0u, 0u, 0u, 0u);
  if (valid) {
    const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ss * (1.f / kHd), eps)));
    float gf[8], y[8], r[8];
    unpack8(*reinterpret_cast<const uint4*>((second ? gb : ga) + chunk * 8), gf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float yb = __bfloat162float(__float2bfloat16_rn(__fmul_rn(xf[j], rs)));
      y[j] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(yb, gf[j])));
    }
    const float4* cp = reinterpret_cast<const float4*>(cosf + (long long)s * kHd + chunk * 8);
    const float4* sp = reinterpret_cast<const float4*>(sinf + (long long)s * kHd + chunk * 8);
    const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float e = y[2 * p], o = y[2 * p + 1];
      r[2 * p] = __fadd_rn(__fmul_rn(e, c[2 * p]), __fmul_rn(o, sn[2 * p]));
      r[2 * p + 1] = __fadd_rn(__fmul_rn(o, c[2 * p + 1]), __fmul_rn(e, sn[2 * p + 1]));
    }
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(out + orow * kHd + chunk * 8) = res;
}

int launch_per_head(const void* xa, long long stride_a, const void* xb, long long stride_b,
                    const void* ga, const void* gb, const void* cos, const void* sin,
                    void* out, int B, int S_a, int S_b, int N, int i_pad, int s_pad, float eps,
                    void* stream) {
  const long long total = (long long)B * N * s_pad * kChunks;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  rms_rope_per_head_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)xa, stride_a, (const __nv_bfloat16*)xb, stride_b,
      (const __nv_bfloat16*)ga, (const __nv_bfloat16*)gb, (const float*)cos, (const float*)sin,
      (__nv_bfloat16*)out, S_a, S_b, N, i_pad, s_pad, eps, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, S, N*128) bf16; rowscale: (B, S) fp32; gamma: (N*128,) bf16;
// cos/sin: (>= S, 128) fp32 rows (ignored when rope == 0);
// out: (B*N, s_pad, 128) bf16.  All contiguous and 16-byte aligned.
extern "C" int fg_rms_rope_heads_major(const void* x, const void* rowscale,
                                       const void* gamma, const void* cos,
                                       const void* sin, void* out, int B, int S,
                                       int N, int s_pad, int rope, void* stream) {
  const long long total = (long long)B * N * s_pad * kChunks;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (rope) {
    rms_rope_kernel<true><<<blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)rowscale, (const __nv_bfloat16*)gamma,
        (const float*)cos, (const float*)sin, (__nv_bfloat16*)out, S, N, s_pad, total);
  } else {
    rms_rope_kernel<false><<<blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)rowscale, (const __nv_bfloat16*)gamma,
        nullptr, nullptr, (__nv_bfloat16*)out, S, N, s_pad, total);
  }
  return (int)cudaGetLastError();
}


// K7.  x: (B, S, N*128) bf16 rows `stride` elements apart (16-byte
// aligned); gamma (128,) bf16; cos/sin: (>= S, 128) fp32 rows; out:
// (B*N, s_pad, 128) bf16.
extern "C" int fg_rms_rope_per_head(const void* x, long long stride, const void* gamma,
                                    const void* cos, const void* sin, void* out, int B, int S,
                                    int N, int s_pad, float eps, void* stream) {
  return launch_per_head(x, stride, x, stride, gamma, gamma, cos, sin, out, B, S, 0, N, s_pad,
                         s_pad, eps, stream);
}

// K8.  Two streams (B, S_img / S_txt, N*128) with their strides and gammas;
// cos/sin: (s_pad, 128) fp32 rows in output-row order; out: (B*N, s_pad,
// 128) bf16 with the image rows at 0 and the text rows at i_pad.
extern "C" int fg_rms_rope_joint(const void* x_img, long long stride_img, const void* x_txt,
                                 long long stride_txt, const void* g_img, const void* g_txt,
                                 const void* cos, const void* sin, void* out, int B, int S_img,
                                 int S_txt, int N, int i_pad, int s_pad, float eps,
                                 void* stream) {
  return launch_per_head(x_img, stride_img, x_txt, stride_txt, g_img, g_txt, cos, sin, out, B,
                         S_img, S_txt, N, i_pad, s_pad, eps, stream);
}
