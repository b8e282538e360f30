// K6a in fp32 at head dim 64 on Hopper's tensor cores (sm_90a): the flash
// attention forward with its log-sum-exp on head-major fp32 q/k/v (B*N,
// S_pad, 64).  The masked Style-DoRA finetune of the SDXL UNet trains in
// fp32, and SDXL's heads are 64 wide, so every attention forward of its
// train step comes here; its backward (K6b, K6c) is in
// csrc/flash_attention_fp32_bwd.cu.
//
// Replaces the TPU kernel fairygen_tpu/ops/flash_attention.py, run on fp32
// inputs:
//   K6a _fa_fwd_lse_kernel (:253)  o = softmax2(S) V and lse = m + log2(l)
// Contract (the bf16 kernels' of csrc/flash_attention_online.cu): q carries
// hd^-1/2 * log2(e), so the logits S = Q K^T are base 2; key columns >=
// sk_actual are masked (P = 0); lse is one fp32 value a row; S_pad is a
// multiple of 64 and rows past the sequence are zero.  Every row below
// Sq_pad is written.  No atomics: one consumer warpgroup owns each query
// row, so the same inputs give the same bits on every run.
//
// fp32 accuracy on the tensor cores (3xTF32, csrc/hopper_tf32.cuh): each
// product is three TF32 passes (lo hi, hi lo, hi hi) into one fp32
// accumulator.  The tensor cores' fp32 sums truncate, so P V starts a fresh
// accumulator every key tile and O = alpha O + PV is taken in registers
// with round-to-nearest arithmetic.  The logits, the mask, the running max
// and sum, exp2 (exp2f, about 2 ulp), P and the division by l stay fp32.
//
// Operands.  S = Q K^T reduces over d, so Q and K serve as they lie.  P V
// reduces over keys with P the register A operand, taken from the S
// accumulator, so V must arrive K-major as V^T with each 8 keys permuted
// as 0, 2, 4, 6, 1, 3, 5, 7 (the accumulator's column order).  A pre-pass
// kernel a call (fa_f32_fwd_prep_kernel) writes K's TF32 hi and lo and V^T's
// (transposed, permuted) hi and lo into a workspace.  Q is split where it
// lands: the TMA loads raw fp32 Q into the hi half of its buffer, and its
// consumer rewrites it there as hi and beside it as lo (the split is
// elementwise, so the swizzled layout carries over), once an item.
//
// Bound on the H100: operations.  4 x BN Sq Sk 64 flops at 494.7 / 3
// TFLOP/s (three TF32 passes), or the bytes each input is read and each
// output written once at 3.35 TB/s where larger (the 77-key shapes).  The
// pre-pass's copies of K and V are the design's cost, not the work.
// Design (csrc/flash_attention_fp32_bwd.cu's K6b, turned round):
//   - persistent: one CTA of 384 threads on each SM; warpgroup 0 is the
//     producer, warpgroups 1 and 2 the consumers;
//   - an item is 64 query rows of one head, and each consumer walks items
//     of its own, loaded by a producer warp of its own (one thread issues
//     every TMA load) into its own buffers: Q (hi and lo, 32 KB) and K and
//     V^T of 64 keys (hi and lo, 64 KB), K and V^T each under their own
//     full / empty mbarriers, so the next K loads while this tile's P V
//     runs: 192 KB of 227.  So the last round of items spreads over the
//     SMs' consumers: at 20 x 1024 queries, 160 items of 128 rows (two
//     consumers an item, sharing its key tiles) are two rounds on 132 SMs,
//     320 of 64 rows fill the 264 consumers once and 56 more.  That
//     128-row form lost to this one at all four of a DoRA step's shapes
//     (PERF.md) and is gone;
//   - per 64-key tile each consumer: S (m64n64k8, 24 wgmmas, both operands
//     from shared memory), the mask (key columns >= sk_actual to -inf), the
//     running max across the quad, P = exp2(S - m), the row sums, P's hi
//     and lo as register A fragments, PV (m64n64k8, 24 wgmmas, B = V^T),
//     O = alpha O + PV.  Only ceil(sk_actual / 64) key tiles are computed;
//     the running max restarts at -inf every item;
//   - no branch and no loop the compiler can see sits between a wgmma's
//     issue and its wait (mbarrier waits loop inside their asm, arrivals
//     are predicated), else ptxas serializes the wgmmas.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "hopper_tf32.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// bytes from a 1024-aligned base
struct FwdSmem {
  static constexpr int kBox = 64 * 128;          // 32 fp32 columns of 64 rows
  static constexpr int kHalf = 2 * kBox;         // 64 rows x 64, hi or lo: 16 KB
  static constexpr int kOperand = 2 * kHalf;     // hi, then lo: 32 KB
  static constexpr int kQ = 0;                   // consumer c's Q at kQ + c kOperand
  static constexpr int kKv = 2 * kOperand;       // consumer c's K, then V^T, at kKv + c kStage
  static constexpr int kStage = 2 * kOperand;
  static constexpr int kBar = kKv + 2 * kStage;  // 192 KB
  static constexpr int kBytes = kBar + 12 * 8 + 1024;  // + 1024-alignment slack
};

struct FwdParams {
  float* out;
  float* lse;
  int sq_pad, sk_actual;
  int n_blocks, n_items, n_tiles;  // row blocks a head, items, 64-key tiles
};

// the two rows' maxima across the quad that shares them
__device__ __forceinline__ void quad_max(float& mx0, float& mx1) {
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
}

// this warpgroup's 64 rows of Q, loaded raw into the hi half, as hi there
// and lo in the lo half (32 values a thread)
__device__ __forceinline__ void split_q_in_place(uint8_t* q, int tid) {
  float4* hi4 = reinterpret_cast<float4*>(q);
  float4* lo4 = reinterpret_cast<float4*>(q + FwdSmem::kHalf);
#pragma unroll
  for (int it = 0; it < FwdSmem::kHalf / 16 / 128; ++it) {
    const int idx = it * 128 + tid;
    const float4 x = hi4[idx];
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    hi4[idx] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                           __uint_as_float(h[3]));
    lo4[idx] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                           __uint_as_float(l[3]));
  }
}

// rows `row` and row + 8 of head bn = O / l (correctly rounded), and their
// lse = m + log2(l)
__device__ __forceinline__ void store_rows(const FwdParams& pr, const float* o, float l0,
                                           float l1, float m0, float m1, int bn, int row,
                                           int tg) {
  // the four threads of a quad hold disjoint columns of the same two rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = __frcp_rn(l0), inv1 = __frcp_rn(l1);
  // column 8j + 2tg of the row is the float2 4j + tg
  float2* dst = reinterpret_cast<float2*>(pr.out + ((size_t)bn * pr.sq_pad + row) * kD) + tg;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    dst[4 * j] = make_float2(div_rn(o[4 * j], l0, inv0), div_rn(o[4 * j + 1], l0, inv0));
    dst[8 * (kD / 2) + 4 * j] =
        make_float2(div_rn(o[4 * j + 2], l1, inv1), div_rn(o[4 * j + 3], l1, inv1));
  }
  // one thread of each quad (all four hold the rows' m and summed l)
  float* lse = pr.lse + (size_t)bn * pr.sq_pad + row;
  if (tg == 0) {
    lse[0] = m0 + log2f(l0);
    lse[8] = m1 + log2f(l1);
  }
}

// an item is 64 query rows of one head; consumer c of CTA b (of G) takes
// items c G + b, c G + b + 2G, ..., producer warp c loads them into its
// buffers, and the two consumers share nothing but the SM
__global__ void __launch_bounds__(kThreads, 1)
fa_f32_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdParams pr) {
  using L = FwdSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;  // [consumer]: its Q rows of an item
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;  // [consumer]: K of a tile
  uint64_t* k_empty = bars + 6;
  uint64_t* v_full = bars + 8;  // [consumer]: V^T of a tile
  uint64_t* v_empty = bars + 10;
  const int wg = threadIdx.x / 128;
  const int stride = 2 * gridDim.x;

  if (threadIdx.x == 0) {
    for (int c = 0; c < 2; ++c) {  // an empty barrier: one arrival per warp of consumer c
      mbar_init(&q_full[c], 1);
      mbar_init(&q_empty[c], 4);
      mbar_init(&k_full[c], 1);
      mbar_init(&k_empty[c], 4);
      mbar_init(&v_full[c], 1);
      mbar_init(&v_empty[c], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: lane 0 of warp c issues every load of consumer c
    setmaxnreg_dec<kProducerRegs>();
    const int c = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0 && c < 2) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      uint8_t* kv = smem + L::kKv + c * L::kStage;
      int t = 0;
      for (int i = 0, w = c * gridDim.x + blockIdx.x; w < pr.n_items; ++i, w += stride) {
        const int bn = w / pr.n_blocks, r0 = (w % pr.n_blocks) * 64;
        // the item's rows once the consumer's last S of item i - 1 is in
        mbar_wait(&q_empty[c], (i & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[c], L::kHalf);
        for (int b = 0; b < 2; ++b)
          tma_load_3d(smem + L::kQ + c * L::kOperand + b * L::kBox, &tq, &q_full[c], 32 * b,
                      r0, bn);
        for (int j = 0; j < pr.n_tiles; ++j, ++t) {
          const uint32_t ph = t & 1;
          mbar_wait(&k_empty[c], ph ^ 1);
          mbar_arrive_expect_tx(&k_full[c], L::kOperand);
          for (int m = 0; m < 2; ++m)
            for (int b = 0; b < 2; ++b)
              tma_load_4d(kv + m * L::kHalf + b * L::kBox, &tk, &k_full[c], 32 * b, j * 64, bn,
                          m);
          mbar_wait(&v_empty[c], ph ^ 1);
          mbar_arrive_expect_tx(&v_full[c], L::kOperand);
          for (int m = 0; m < 2; ++m)
            for (int b = 0; b < 2; ++b)
              tma_load_4d(kv + L::kOperand + m * L::kHalf + b * L::kBox, &tv, &v_full[c],
                          j * 64 + 32 * b, 0, bn, m);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 is consumer 0, warpgroup 2 consumer 1
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + (lane >> 2), tg = lane & 3;
    const uint32_t base = smem_u32(smem);
    const uint32_t q_rows = base + L::kQ + cw * L::kOperand;
    float s[32], pv[32], o[32];
    uint32_t ph_[32], pl_[32];
    int t = 0;
    for (int i = 0, w = cw * gridDim.x + blockIdx.x; w < pr.n_items; ++i, w += stride) {
      const int bn = w / pr.n_blocks, row = (w % pr.n_blocks) * 64 + r;
      mbar_wait(&q_full[cw], i & 1);
      split_q_in_place(smem + L::kQ + cw * L::kOperand, tid);
      fence_proxy_async_smem();  // the split, seen by the wgmmas
      named_bar_sync(1 + cw, 128);
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int k = 0; k < 32; ++k) o[k] = 0.f;
      for (int j = 0; j < pr.n_tiles; ++j, ++t) {
        const uint32_t ph = t & 1;
        const uint32_t kb = opaque(base) + L::kKv + cw * L::kStage;
        mbar_wait(&k_full[cw], ph);
        wgmma_fence();
        products_over_d<64>(s, opaque(q_rows), L::kBox, L::kHalf, kb, L::kBox, L::kHalf);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(s);
        mbar_arrive_if(&k_empty[cw], lane == 0);
        mbar_arrive_if(&q_empty[cw], lane == 0 && j == pr.n_tiles - 1);
        // key column 8jj + 2tg + e of the tile is real while 8jj + e < lim
        // (lim >= 64 before the last tile)
        const int lim = pr.sk_actual - j * 64 - 2 * tg;
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool out = 8 * jj + e >= lim;
            s[4 * jj + e] = out ? -INFINITY : s[4 * jj + e];
            s[4 * jj + 2 + e] = out ? -INFINITY : s[4 * jj + 2 + e];
            mx0 = fmaxf(mx0, s[4 * jj + e]);
            mx1 = fmaxf(mx1, s[4 * jj + 2 + e]);
          }
        // finite: every computed tile holds a key
        quad_max(mx0, mx1);
        mx0 = fmaxf(m0, mx0);
        mx1 = fmaxf(m1, mx1);
        const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          s[4 * jj] = exp2f(s[4 * jj] - m0);
          s[4 * jj + 1] = exp2f(s[4 * jj + 1] - m0);
          s[4 * jj + 2] = exp2f(s[4 * jj + 2] - m1);
          s[4 * jj + 3] = exp2f(s[4 * jj + 3] - m1);
          r0 += s[4 * jj] + s[4 * jj + 1];
          r1 += s[4 * jj + 2] + s[4 * jj + 3];
        }
        l0 = l0 * a0 + r0;
        l1 = l1 * a1 + r1;
        to_tf32_fragments<8>(s, ph_, pl_);
        fence_regs<32>(ph_);
        fence_regs<32>(pl_);
        mbar_wait(&v_full[cw], ph);
        wgmma_fence();
        products_over_rows<8>(pv, ph_, pl_, kb + L::kOperand, L::kHalf);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(pv);
        mbar_arrive_if(&v_empty[cw], lane == 0);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[4 * jj] = o[4 * jj] * a0 + pv[4 * jj];
          o[4 * jj + 1] = o[4 * jj + 1] * a0 + pv[4 * jj + 1];
          o[4 * jj + 2] = o[4 * jj + 2] * a1 + pv[4 * jj + 2];
          o[4 * jj + 3] = o[4 * jj + 3] * a1 + pv[4 * jj + 3];
        }
      }
      store_rows(pr, o, l0, l1, m0, m1, bn, row, tg);
    }
  }
}

// ------------------------------------------------------------ pre-pass
// The workspace, floats from its base: [K hi, K lo] (BN, Sk_pad, 64) each,
// then [V^T hi, V^T lo] (BN, 64, Sk_pad) each, every 8 keys of V^T permuted.

struct PrepParams {
  const float* k;
  const float* v;
  float* ws;
  int sk_pad;
};

// a 64 x 64 tile of k (blockIdx.z 0) into its hi and lo, or of v (1) into
// its transposed, permuted hi and lo
__global__ void __launch_bounds__(256) fa_f32_fwd_prep_kernel(const PrepParams p) {
  __shared__ float tile[64][65];
  const size_t nk = (size_t)gridDim.y * p.sk_pad * kD;
  const int row0 = blockIdx.x * 64;
  const size_t off = ((size_t)blockIdx.y * p.sk_pad + row0) * kD;
  const float4* src = reinterpret_cast<const float4*>((blockIdx.z == 0 ? p.k : p.v) + off);
  if (blockIdx.z == 0) {
    float4* hi4 = reinterpret_cast<float4*>(p.ws + off);
    float4* lo4 = reinterpret_cast<float4*>(p.ws + nk + off);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = it * 256 + threadIdx.x;
      const float4 x = src[idx];
      uint32_t h[4], l[4];
      split_tf32(x.x, h[0], l[0]);
      split_tf32(x.y, h[1], l[1]);
      split_tf32(x.z, h[2], l[2]);
      split_tf32(x.w, h[3], l[3]);
      hi4[idx] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                             __uint_as_float(h[2]), __uint_as_float(h[3]));
      lo4[idx] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                             __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
    return;
  }
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * 256 + threadIdx.x;
    const float4 x = src[idx];
    float* row = &tile[idx >> 4][(idx & 15) * 4];
    row[0] = x.x;
    row[1] = x.y;
    row[2] = x.z;
    row[3] = x.w;
  }
  __syncthreads();
  float* tt = p.ws + 2 * nk;
  const size_t head = (size_t)blockIdx.y * kD * p.sk_pad;
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int idx = it * 256 + threadIdx.x;
    const int d = idx >> 6, pp = idx & 63;
    uint32_t h, l;
    split_tf32(tile[permuted_row(pp)][d], h, l);
    const size_t at = head + (size_t)d * p.sk_pad + row0 + pp;
    tt[at] = __uint_as_float(h);
    tt[nk + at] = __uint_as_float(l);
  }
}

int allow_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Shapes (checked by the Python wrapper): qh, out (BN, sq_pad, 64) fp32,
// lse (BN, sq_pad) fp32; kh, vh (BN, sk_pad, 64) fp32; sq_pad and sk_pad
// multiples of 64; 1 <= sk_actual <= sk_pad; ws holds 4 BN sk_pad 64
// floats (the layout above); every pointer 16-byte aligned.

// the pre-pass of a K6a call into ws
extern "C" int fg_flash_fwd_prep_f32(const void* kh, const void* vh, void* ws, int BN,
                                     int sk_pad, void* stream) {
  PrepParams p = {};
  p.k = (const float*)kh;
  p.v = (const float*)vh;
  p.ws = (float*)ws;
  p.sk_pad = sk_pad;
  fa_f32_fwd_prep_kernel<<<dim3(sk_pad / 64, BN, 2), 256, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// K6a from q and the pre-pass's workspace
extern "C" int fg_flash_fwd_lse_f32_tc(const void* qh, const void* ws, void* out, void* lse,
                                       int BN, int sq_pad, int sk_actual, int sk_pad,
                                       void* stream) {
  static int rc_smem = allow_smem((const void*)fa_f32_fwd_tc_kernel, FwdSmem::kBytes);
  if (rc_smem) return rc_smem;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  const size_t nk = (size_t)BN * sk_pad * kD;
  CUtensorMap maps[3];
  const cuuint64_t qdims[3] = {kD, (cuuint64_t)sq_pad, (cuuint64_t)BN};
  const cuuint64_t qstr[2] = {kD * 4, (cuuint64_t)sq_pad * kD * 4};
  const cuuint32_t qbox[3] = {32, 64, 1};
  int rc = make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, qh, 3, qdims, qstr, qbox);
  if (rc) return rc;
  const cuuint64_t kdims[4] = {kD, (cuuint64_t)sk_pad, (cuuint64_t)BN, 2};
  const cuuint64_t kstr[3] = {kD * 4, (cuuint64_t)sk_pad * kD * 4, (cuuint64_t)nk * 4};
  const cuuint32_t box[4] = {32, 64, 1, 1};
  if ((rc = make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, 4, kdims, kstr, box)))
    return rc;
  const cuuint64_t vdims[4] = {(cuuint64_t)sk_pad, kD, (cuuint64_t)BN, 2};
  const cuuint64_t vstr[3] = {(cuuint64_t)sk_pad * 4, (cuuint64_t)sk_pad * kD * 4,
                              (cuuint64_t)nk * 4};
  if ((rc = make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (const float*)ws + 2 * nk, 4,
                     vdims, vstr, box)))
    return rc;
  FwdParams pr = {};
  pr.out = (float*)out;
  pr.lse = (float*)lse;
  pr.sq_pad = sq_pad;
  pr.sk_actual = sk_actual;
  pr.n_blocks = sq_pad / 64;
  pr.n_items = pr.n_blocks * BN;
  pr.n_tiles = (sk_actual + 63) / 64;
  const int ctas = (pr.n_items + 1) / 2;  // two consumers a CTA
  fa_f32_fwd_tc_kernel<<<ctas < sms ? ctas : sms, kThreads, FwdSmem::kBytes,
                         (cudaStream_t)stream>>>(maps[0], maps[1], maps[2], pr);
  return (int)cudaGetLastError();
}

// dynamic shared memory of K6a fp32, in bytes (printed by chip_smoke.py)
extern "C" int fg_flash_f32_smem_bytes() { return FwdSmem::kBytes; }
