// K6a in fp32 at head dim 64: the flash attention forward with its
// log-sum-exp on head-major fp32 q/k/v (B*N, S_pad, 64), for Hopper
// (sm_90a).  The masked Style-DoRA finetune of the SDXL UNet trains in fp32,
// and SDXL's heads are 64 wide, so every attention forward of its train step
// comes here; its backward (K6b, K6c) runs on the tensor cores in
// csrc/flash_attention_fp32_bwd.cu (3xTF32 wgmma).
//
// Replaces the TPU kernel fairygen_tpu/ops/flash_attention.py, run on fp32
// inputs:
//   K6a _fa_fwd_lse_kernel (:253)  o = softmax2(S) V and lse = m + log2(l)
// Contract (the bf16 kernels' of csrc/flash_attention_online.cu): q carries
// hd^-1/2 * log2(e), so the logits S = Q K^T are base 2; key columns >=
// sk_actual are masked (P = 0); lse is one fp32 value a row; S_pad is a
// multiple of 64 and rows past the sequence are zero.  Everything is fp32:
// the logits, exp2, P (the Pallas kernel's rounding of p to v's dtype is a
// no-op here) and every sum.  Every row below Sq_pad is written.  No
// atomics: a CTA owns its query rows, as the TPU kernel splits the work, so
// the same inputs give the same bits on every run.
//
// Bound on the H100: operations.  This first design runs on the CUDA
// cores' FFMA (not yet moved to the tensor cores as K6b and K6c were):
// 4 x BN Sq Sk 64 flops (S, PV) at 67 TFLOP/s, 0.64 ms at 10 heads x 4096 x
// 4096, against a few hundred bytes a row.  Design (simple):
//   - a CTA of 256 threads owns 64 query rows of one head and loops over
//     the keys in tiles of 64, blockIdx.x the row block and blockIdx.y the
//     head, so the CTAs that run together share a head's tiles in L2;
//   - tiles live in shared memory row-major with a row stride of 68 floats
//     (16-byte aligned rows; rows 4 banks apart), loaded by coalesced
//     float4 reads, never transposed;
//   - thread (ty, tx) = (tid / 16, tid % 16) computes a 4 x 4 micro-tile.
//     S = Q K^T reads both operands as float4 along d, its own 4 rows ty*4 +
//     i (broadcast within a half-warp) against the columns tx + 16 j (eight
//     threads of a quarter-warp hit eight distinct 4-bank groups).  P V
//     takes P from a shared buffer the threads wrote from their registers
//     already transposed, one float4 of 4 rows per tile column, and V as a
//     float4 of 4 consecutive columns of a row-major tile: 2 shared loads
//     for 16 FFMA either way;
//   - the running max and sum are reduced over the 16 threads of a row with
//     shuffles inside a half-warp;
//   - only ceil(sk_actual / 64) key tiles are computed: the others add
//     exact zeros;
//   - exp2f is the hardware ex2 (about 2 ulp), so P lies within a few ulp of
//     the plain version's exp2.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kT = 64;        // rows of a tile
constexpr int kLd = 68;       // shared row stride, floats
constexpr int kThreads = 256;
constexpr int kTile = kT * kLd;  // floats of one shared tile

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out0;  // o
  float* out1;  // lse
  int sq_pad, sk_actual, sk_pad;
};

// rows [row0, row0 + 64) of a (S_pad, 64) fp32 head into a shared tile
__device__ __forceinline__ void load_tile(float* sm, const float* g, int row0) {
  const float4* src = reinterpret_cast<const float4*>(g + (size_t)row0 * kD);
#pragma unroll
  for (int it = 0; it < kT * kD / 4 / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx >> 4, c4 = idx & 15;
    *reinterpret_cast<float4*>(sm + r * kLd + c4 * 4) = src[idx];
  }
}

// acc[i][j] = sum_d A[ty*4 + i][d] * B[tx + 16 j][d] over two shared tiles
__device__ __forceinline__ void product_over_d(float acc[4][4], const float* a, const float* b,
                                               int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][c] += sum_t X[t][ty*4 + i] * Y[t][tx*4 + c]: X a buffer written as
// (tile column, own row), Y a row-major tile
__device__ __forceinline__ void product_over_tile(float acc[4][4], const float* x, const float* y,
                                                  int ty, int tx) {
#pragma unroll 8
  for (int t = 0; t < kT; ++t) {
    const float4 xv = *reinterpret_cast<const float4*>(x + t * kLd + ty * 4);
    const float4 yv = *reinterpret_cast<const float4*>(y + t * kLd + tx * 4);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(xs[i], yv.x, acc[i][0]);
      acc[i][1] = fmaf(xs[i], yv.y, acc[i][1]);
      acc[i][2] = fmaf(xs[i], yv.z, acc[i][2]);
      acc[i][3] = fmaf(xs[i], yv.w, acc[i][3]);
    }
  }
}

// vals[i][j] (own row ty*4 + i, tile column tx + 16 j) into buf[column][row]
__device__ __forceinline__ void store_transposed(float* buf, const float vals[4][4], int ty,
                                                 int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(buf + (tx + 16 * j) * kLd + ty * 4) =
        make_float4(vals[0][j], vals[1][j], vals[2][j], vals[3][j]);
}

// a 4 x 4 register tile (own rows, columns tx*4 + c) to rows row0 + ty*4 + i
__device__ __forceinline__ void store_rows(float* g, int row0, const float acc[4][4], int ty,
                                           int tx, float f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(g + (size_t)(row0 + ty * 4 + i) * kD + tx * 4) =
        make_float4(acc[i][0] * f, acc[i][1] * f, acc[i][2] * f, acc[i][3] * f);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// K6a: shared Q, K, V, P^T
constexpr int kFwdSmem = 4 * kTile * 4;

__global__ void __launch_bounds__(kThreads) fa_f32_fwd_lse_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kTile;
  float* sv = sk + kTile;
  float* sp = sv + kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row0 = blockIdx.x * kT;
  const size_t head_q = (size_t)blockIdx.y * p.sq_pad * kD;
  const size_t head_k = (size_t)blockIdx.y * p.sk_pad * kD;
  load_tile(sq, p.q + head_q, row0);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = (p.sk_actual + kT - 1) / kT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's K, V and P^T are read
    load_tile(sk, p.k + head_k, kt * kT);
    load_tile(sv, p.v + head_k, kt * kT);
    __syncthreads();
    float s[4][4];
    product_over_d(s, sq, sk, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kt * kT + tx + 16 * j >= p.sk_actual)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_warp_max(mx));  // finite: a tile holds a key
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    store_transposed(sp, s, ty, tx);
    __syncthreads();
    product_over_tile(acc, sp, sv, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] *= inv;
  }
  store_rows(p.out0 + head_q, row0, acc, ty, tx, 1.f);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p.out1[(size_t)blockIdx.y * p.sq_pad + row0 + ty * 4 + i] = m[i] + log2f(l[i]);
  }
}

typedef void (*F32Kernel)(Params);

int allow_smem(F32Kernel kernel, int smem_bytes) {
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// grid (rows / 64, BN): blockIdx.x the row block, blockIdx.y the head
int launch(F32Kernel kernel, int smem_rc, int smem_bytes, int rows, int BN, const Params& p,
           void* stream) {
  if (smem_rc) return smem_rc;
  kernel<<<dim3(rows / kT, BN), kThreads, smem_bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fg_flash_fwd_lse_f32(const void* qh, const void* kh, const void* vh, void* out,
                                    void* lse, int BN, int sq_pad, int sk_actual, int sk_pad,
                                    void* stream) {
  Params p = {};
  p.q = (const float*)qh;
  p.k = (const float*)kh;
  p.v = (const float*)vh;
  p.out0 = (float*)out;
  p.out1 = (float*)lse;
  p.sq_pad = sq_pad;
  p.sk_actual = sk_actual;
  p.sk_pad = sk_pad;
  static int rc = allow_smem(fa_f32_fwd_lse_kernel, kFwdSmem);
  return launch(fa_f32_fwd_lse_kernel, rc, kFwdSmem, sq_pad, BN, p, stream);
}

// dynamic shared memory of K6a, in bytes (printed by chip_smoke.py)
extern "C" int fg_flash_f32_smem_bytes() { return kFwdSmem; }
