// K6a, K6b and K6c in fp32 at head dim 64: flash attention with a gradient
// on head-major fp32 q/k/v/dO (B*N, S_pad, 64), for Hopper (sm_90a).  The
// masked Style-DoRA finetune of the SDXL UNet trains in fp32, and SDXL's
// heads are 64 wide, so every attention of its train step comes here.
//
// Replaces the TPU kernels fairygen_tpu/ops/flash_attention.py, run on fp32
// inputs:
//   K6a _fa_fwd_lse_kernel (:253)  o = softmax2(S) V and lse = m + log2(l)
//   K6b _fa_bwd_dq_kernel  (:295)  dQ = f * sum_j [P o (dP - delta)] K_j
//   K6c _fa_bwd_dkv_kernel (:329)  dV = sum_i P^T dO_i,
//                                  dK = sum_i [P o (dP - delta)]^T Q_i / log2(e)
// Contract (the bf16 kernels' of csrc/flash_attention_online.cu and
// csrc/flash_attention_bwd.cu): q carries hd^-1/2 * log2(e), so the logits
// S = Q K^T are base 2; key columns >= sk_actual are masked (P = 0); lse is
// one fp32 value a row, delta = sum_d dO * O one fp32 value a row from the
// caller; S_pad is a multiple of 64 and rows past the sequence are zero.
// Everything is fp32: the logits, exp2, P and dS (the Pallas kernels'
// rounding of p to v's dtype is a no-op here) and every sum.  K6a and K6b
// write every row below Sq_pad; K6c skips queries >= sq (P = 0 there,
// whatever the padded rows of lse and delta hold), writes every row below
// Sk_pad, and key rows >= sk_actual come out exactly 0.  No atomics: K6a and
// K6b own query rows, K6c key rows, as the TPU kernels split the work, so
// the same inputs give the same bits on every run.
//
// Bound on the H100: operations.  Hopper's tensor cores have no fp32
// product (TF32 keeps 10 mantissa bits, about 1e-3 relative, far from the
// fp32 reference), so these kernels run on the CUDA cores' FFMA: 4 (K6a: S,
// PV), 6 (K6b: S, dP, dQ) and 8 (K6c: S, dP, dV, dK) x BN Sq Sk 64 flops at
// 67 TFLOP/s, 0.64, 0.96 and 1.28 ms at 10 heads x 4096 x 4096, against a
// few hundred bytes a row.  Design (deliberately simple):
//   - a CTA of 256 threads owns 64 rows of one head (query rows for K6a and
//     K6b, key rows for K6c) and loops over the other side in tiles of 64,
//     blockIdx.x the row block and blockIdx.y the head, so the CTAs that
//     run together share a head's tiles in L2;
//   - tiles live in shared memory row-major with a row stride of 68 floats
//     (16-byte aligned rows; rows 4 banks apart), loaded by coalesced
//     float4 reads, never transposed;
//   - thread (ty, tx) = (tid / 16, tid % 16) computes a 4 x 4 micro-tile.
//     A product that reduces over d (S = Q K^T, dP = dO V^T and, in K6c,
//     their transposes) reads both operands as float4 along d, its own 4
//     rows ty*4 + i (broadcast within a half-warp) against the columns tx +
//     16 j (eight threads of a quarter-warp hit eight distinct 4-bank
//     groups).  A product that reduces over the tile (P V, dS K, P^T dO,
//     dS^T Q) takes the first factor from a shared buffer the threads wrote
//     from their registers already transposed, one float4 of 4 rows per
//     tile column, and the second as a float4 of 4 consecutive columns of a
//     row-major tile: 2 shared loads for 16 FFMA either way;
//   - row statistics (K6a's running max and sum) are reduced over the 16
//     threads of a row with shuffles inside a half-warp;
//   - only ceil(sk_actual / 64) key tiles (K6a, K6b) or ceil(sq / 64) query
//     tiles (K6c) are computed: the others add exact zeros;
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
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* out0;   // o (K6a), dq (K6b), dk (K6c)
  float* out1;   // lse (K6a), dv (K6c)
  int sq, sq_pad, sk_actual, sk_pad;
  float dq_factor;
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

// K6b: shared Q, dO, K, V, dS^T
constexpr int kDqSmem = 5 * kTile * 4;

__global__ void __launch_bounds__(kThreads) fa_f32_bwd_dq_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + kTile;
  float* sk = sdo + kTile;
  float* sv = sk + kTile;
  float* sds = sv + kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row0 = blockIdx.x * kT;
  const size_t head_q = (size_t)blockIdx.y * p.sq_pad * kD;
  const size_t head_k = (size_t)blockIdx.y * p.sk_pad * kD;
  load_tile(sq, p.q + head_q, row0);
  load_tile(sdo, p.dout + head_q, row0);
  float lse[4], dlt[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = (size_t)blockIdx.y * p.sq_pad + row0 + ty * 4 + i;
    lse[i] = p.lse[r];
    dlt[i] = p.delta[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = (p.sk_actual + kT - 1) / kT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_tile(sk, p.k + head_k, kt * kT);
    load_tile(sv, p.v + head_k, kt * kT);
    __syncthreads();
    float s[4][4], dp[4][4];
    product_over_d(s, sq, sk, ty, tx);
    product_over_d(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool keep = kt * kT + tx + 16 * j < p.sk_actual;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = keep ? exp2f(s[i][j] - lse[i]) * (dp[i][j] - dlt[i]) : 0.f;
    }
    store_transposed(sds, s, ty, tx);
    __syncthreads();
    product_over_tile(acc, sds, sk, ty, tx);
  }
  store_rows(p.out0 + head_q, row0, acc, ty, tx, p.dq_factor);
}

// K6c: shared K, V, Q, dO, P (query, key), dS (query, key), lse, delta
constexpr int kDkvSmem = 6 * kTile * 4 + 2 * kT * 4;

__global__ void __launch_bounds__(kThreads) fa_f32_bwd_dkv_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + kTile;
  float* sq = sv + kTile;
  float* sdo = sq + kTile;
  float* spb = sdo + kTile;
  float* sdsb = spb + kTile;
  float* slse = sdsb + kTile;
  float* sdlt = slse + kT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row0 = blockIdx.x * kT;
  const size_t head_q = (size_t)blockIdx.y * p.sq_pad * kD;
  const size_t head_k = (size_t)blockIdx.y * p.sk_pad * kD;
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;
  const int n_tiles = row0 < p.sk_actual ? (p.sq + kT - 1) / kT : 0;
  if (n_tiles) {
    load_tile(sk, p.k + head_k, row0);
    load_tile(sv, p.v + head_k, row0);
  }
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = row0 + ty * 4 + i < p.sk_actual;
  for (int qt = 0; qt < n_tiles; ++qt) {
    __syncthreads();
    load_tile(sq, p.q + head_q, qt * kT);
    load_tile(sdo, p.dout + head_q, qt * kT);
    if (threadIdx.x < kT) {
      const size_t r = (size_t)blockIdx.y * p.sq_pad + qt * kT + threadIdx.x;
      slse[threadIdx.x] = p.lse[r];
      sdlt[threadIdx.x] = p.delta[r];
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    product_over_d(s, sk, sq, ty, tx);   // S^T: own key rows, query columns
    product_over_d(dp, sv, sdo, ty, tx);  // dP^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const bool q_ok = qt * kT + col < p.sq;
      const float lse_c = slse[col], dlt_c = sdlt[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = q_ok && key_ok[i];
        const float pr = ok ? exp2f(s[i][j] - lse_c) : 0.f;
        dp[i][j] = ok ? pr * (dp[i][j] - dlt_c) : 0.f;
        s[i][j] = pr;
      }
    }
    store_transposed(spb, s, ty, tx);
    store_transposed(sdsb, dp, ty, tx);
    __syncthreads();
    product_over_tile(dv, spb, sdo, ty, tx);
    product_over_tile(dk, sdsb, sq, ty, tx);
  }
  store_rows(p.out0 + head_k, row0, dk, ty, tx, 1.f / kLog2e);
  store_rows(p.out1 + head_k, row0, dv, ty, tx, 1.f);
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

extern "C" int fg_flash_bwd_dq_f32(const void* qh, const void* kh, const void* vh,
                                   const void* doh, const void* lse, const void* delta, void* dq,
                                   float dq_factor, int BN, int sq_pad, int sk_actual,
                                   int sk_pad, void* stream) {
  Params p = {};
  p.q = (const float*)qh;
  p.k = (const float*)kh;
  p.v = (const float*)vh;
  p.dout = (const float*)doh;
  p.lse = (const float*)lse;
  p.delta = (const float*)delta;
  p.out0 = (float*)dq;
  p.sq_pad = sq_pad;
  p.sk_actual = sk_actual;
  p.sk_pad = sk_pad;
  p.dq_factor = dq_factor;
  static int rc = allow_smem(fa_f32_bwd_dq_kernel, kDqSmem);
  return launch(fa_f32_bwd_dq_kernel, rc, kDqSmem, sq_pad, BN, p, stream);
}

extern "C" int fg_flash_bwd_dkv_f32(const void* qh, const void* kh, const void* vh,
                                    const void* doh, const void* lse, const void* delta,
                                    void* dk, void* dv, int BN, int sq, int sq_pad,
                                    int sk_actual, int sk_pad, void* stream) {
  Params p = {};
  p.q = (const float*)qh;
  p.k = (const float*)kh;
  p.v = (const float*)vh;
  p.dout = (const float*)doh;
  p.lse = (const float*)lse;
  p.delta = (const float*)delta;
  p.out0 = (float*)dk;
  p.out1 = (float*)dv;
  p.sq = sq;
  p.sq_pad = sq_pad;
  p.sk_actual = sk_actual;
  p.sk_pad = sk_pad;
  static int rc = allow_smem(fa_f32_bwd_dkv_kernel, kDkvSmem);
  return launch(fa_f32_bwd_dkv_kernel, rc, kDkvSmem, sk_pad, BN, p, stream);
}

// dynamic shared memory of K6a (which = 0), K6b (1) or K6c (2), in bytes
// (printed by chip_smoke.py)
extern "C" int fg_flash_f32_smem_bytes(int which) {
  return which == 0 ? kFwdSmem : which == 1 ? kDqSmem : kDkvSmem;
}
