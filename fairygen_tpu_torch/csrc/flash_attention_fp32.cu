// The fp32 flash attention forward on Hopper's tensor cores (sm_90a), on
// head-major fp32 q/k/v (B*N, S_pad, d): K6a at head dim 64 (with its
// log-sum-exp), and K5 and K4's max and masked forms at head dims 8, 16,
// 40, 64, 80 and 160 (no log-sum-exp).  The masked Style-DoRA finetune of
// the SDXL UNet trains in fp32 (heads of 64), so every attention forward of
// its train step comes here as K6a; its backward (K6b, K6c) is in
// csrc/flash_attention_fp32_bwd.cu.  The SDXL and SD1.5 BrushNet pipelines
// run in fp32 by default, so every attention of their UNets and BrushNets
// comes here as K5 (more keys than one TPU k tile) or K4 (at most 1024).
//
// Replaces the TPU kernels of fairygen_tpu/ops/flash_attention.py, run on
// fp32 inputs:
//   K6a _fa_fwd_lse_kernel (:253)  o = softmax2(S) V and lse = m + log2(l)
//   K5  _fa_kernel (:35)           o = softmax2(S) V, a running max
//   K4  _fa_small_kv_kernel (:133), bounded=False: the row max over its one
//       k tile, keys >= sk_actual masked where they are padded or cut.
// In fp32 the Pallas kernels round nothing: p.astype(v.dtype) (:70, :161)
// is a no-op, so K4's max and masked forms compute the function K5 does up
// to fp32 rounding, and both run the online softmax here (no row-max
// pre-pass, which K4 needs in bf16 to round p as Pallas does).
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
// (transposed, permuted) hi and lo into a workspace, at the true width d.
// Q is split where it lands: the TMA loads raw fp32 Q into the hi half of
// its buffer, and its consumer rewrites it there as hi and beside it as lo
// (the split is elementwise, so the swizzled layout carries over), once an
// item.
//
// Widths.  An instance computes DP columns in 32-column (128-byte) boxes:
// DP = 32 for d 8 and 16, 64 for d 40 and 64, 96 for d 80, 160 for d 160.
// The TMA maps take the true width d, so the columns of Q and K and the
// rows of V^T past d read zeros, add nothing to S and give zero columns of
// O, which the store leaves out (the bf16 kernels' design at these dims).
// No box lies wholly past d: each reads some real columns.
//
// Bound on the H100: operations.  4 x BN Sq Sk d flops at 494.7 / 3
// TFLOP/s (three TF32 passes), or the bytes each input is read and each
// output written once at 3.35 TB/s where larger (the 77-key shapes), or
// the exp2 at 16 a clock an SM (small d).  The pre-pass's copies of K and V
// are the design's cost, not the work.
// Design (csrc/flash_attention_fp32_bwd.cu's K6b, turned round):
//   - persistent: one CTA of 128 (NC + 1) threads on each SM; warpgroup 0
//     is the producer, the NC others the consumers;
//   - an item is 64 query rows of one head, and each consumer walks items
//     of its own, loaded by a producer warp of its own (one thread issues
//     every TMA load) into its own buffers: Q (hi and lo) and K and V^T of
//     KT keys (hi and lo), K and V^T each under their own full / empty
//     mbarriers, so the next K loads while this tile's P V runs.  At DP 64
//     (KT 64, two consumers) that is 192 KB of 227; at DP 96 each buffer
//     grows 1.5x, so its key tiles are 32 keys (192 KB, two consumers); at
//     DP 160 Q alone is 80 KB, so one consumer with 32-key tiles (160 KB).
//     The last round of items spreads over the SMs' consumers: at 20 x
//     1024 queries, 160 items of 128 rows (two consumers an item, sharing
//     its key tiles) are two rounds on 132 SMs, 320 of 64 rows fill the 264
//     consumers once and 56 more.  That 128-row form lost to this one at
//     all four of a DoRA step's shapes (PERF.md) and is gone;
//   - per KT-key tile each consumer: S (m64nKTk8, 3 DP / 8 wgmmas, both
//     operands from shared memory), the mask (key columns >= sk_actual to
//     -inf), the running max across the quad, P = exp2(S - m), the row sums,
//     P's hi and lo as register A fragments, PV (3 KT / 8 wgmmas for each
//     64- or 32-row part of V^T: m64n64k8 / m64n32k8), O = alpha O + PV.
//     Only ceil(sk_actual / KT) key tiles are computed; the running max
//     restarts at -inf every item;
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

constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxD = 160;  // the widest head dim the forward takes

// bytes from a 1024-aligned base, for DP columns, KT-key tiles and NC
// consumers
template <int DP, int KT, int NC>
struct FwdSmem {
  static constexpr int kBoxes = DP / 32;         // 32-column boxes of a row
  static constexpr int kQBox = 64 * 128;         // 32 fp32 columns of 64 rows
  static constexpr int kQHalf = kBoxes * kQBox;  // 64 rows x DP, hi or lo
  static constexpr int kQOp = 2 * kQHalf;        // hi, then lo
  static constexpr int kKBox = KT * 128;         // 32 columns of KT keys
  static constexpr int kVBox = DP * 128;         // 32 keys of DP rows of V^T
  static constexpr int kKvHalf = DP * KT * 4;    // a tile of K or V^T, hi or lo
  static constexpr int kKvOp = 2 * kKvHalf;
  static constexpr int kQ = 0;                   // consumer c's Q at kQ + c kQOp
  static constexpr int kKv = NC * kQOp;          // consumer c's K, then V^T, at kKv + c kStage
  static constexpr int kStage = 2 * kKvOp;
  static constexpr int kBar = kKv + NC * kStage;
  static constexpr int kBytes = kBar + 6 * NC * 8 + 1024;  // + 1024-alignment slack
  static_assert(kQBox % 1024 == 0 && kKBox % 1024 == 0 && kVBox % 1024 == 0, "box alignment");
  static_assert(kBytes <= 232448, "shared memory");
};

struct FwdParams {
  float* out;
  float* lse;  // null: no log-sum-exp (K5, K4)
  int sq_pad, sk_actual, d;
  int n_blocks, n_items, n_tiles;  // row blocks a head, items, KT-key tiles
};

// the two rows' maxima across the quad that shares them
__device__ __forceinline__ void quad_max(float& mx0, float& mx1) {
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
}

// this warpgroup's 64 rows of Q (DP columns), loaded raw into the hi half,
// as hi there and lo in the lo half
template <int DP>
__device__ __forceinline__ void split_q_in_place(uint8_t* q, int tid) {
  constexpr int kHalf = DP / 32 * 64 * 128;
  float4* hi4 = reinterpret_cast<float4*>(q);
  float4* lo4 = reinterpret_cast<float4*>(q + kHalf);
#pragma unroll
  for (int it = 0; it < kHalf / 16 / 128; ++it) {
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

// rows `row` and row + 8 of head bn = O / l (correctly rounded), their d
// columns, and where pr.lse is set (K6a) their lse = m + log2(l)
template <int DP>
__device__ __forceinline__ void store_rows(const FwdParams& pr, const float* o, float l0,
                                           float l1, float m0, float m1, int bn, int row,
                                           int tg) {
  // the four threads of a quad hold disjoint columns of the same two rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = __frcp_rn(l0), inv1 = __frcp_rn(l1);
  // column 8j + 2tg of the row is the float2 4j + tg; d is a multiple of 8,
  // so the 8 columns of group j are all real or all past d
  float2* dst = reinterpret_cast<float2*>(pr.out + ((size_t)bn * pr.sq_pad + row) * pr.d) + tg;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (8 * j < pr.d) {
      dst[4 * j] = make_float2(div_rn(o[4 * j], l0, inv0), div_rn(o[4 * j + 1], l0, inv0));
      dst[4 * pr.d + 4 * j] =
          make_float2(div_rn(o[4 * j + 2], l1, inv1), div_rn(o[4 * j + 3], l1, inv1));
    }
  }
  // one thread of each quad (all four hold the rows' m and summed l)
  if (pr.lse != nullptr && tg == 0) {
    float* lse = pr.lse + (size_t)bn * pr.sq_pad + row;
    lse[0] = m0 + log2f(l0);
    lse[8] = m1 + log2f(l1);
  }
}

// PV (64 x DP) = P (64 x KT, the hi / lo A fragments) V (KT x DP) from
// V^T's rows in parts of 64 and a last of 32, each a fresh accumulator
// (pv[r / 2] holds columns r.. of the part at V^T row r)
template <int DP, int KT, int R0 = 0>
__device__ __forceinline__ void products_pv(float* pv, const uint32_t* ph, const uint32_t* pl,
                                            uint32_t vt, int lo_b) {
  if constexpr (R0 < DP) {
    constexpr int kN = DP - R0 >= 64 ? 64 : 32;
    products_over_rows<KT / 8, kN>(pv + R0 / 2, ph, pl, vt + R0 * 128, lo_b, DP * 128);
    products_pv<DP, KT, R0 + kN>(pv, ph, pl, vt, lo_b);
  }
}

// an item is 64 query rows of one head; consumer c of CTA b (of G) takes
// items c G + b, c G + b + NC G, ..., producer warp c loads them into its
// buffers, and the consumers share nothing but the SM
template <int DP, int KT, int NC>
__device__ __forceinline__ void fwd_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const FwdParams& pr) {
  using L = FwdSmem<DP, KT, NC>;
  constexpr int kS = KT / 2;   // S / P values a thread
  constexpr int kO = DP / 2;   // O / PV values a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;  // [consumer]: its Q rows of an item
  uint64_t* q_empty = bars + NC;
  uint64_t* k_full = bars + 2 * NC;  // [consumer]: K of a tile
  uint64_t* k_empty = bars + 3 * NC;
  uint64_t* v_full = bars + 4 * NC;  // [consumer]: V^T of a tile
  uint64_t* v_empty = bars + 5 * NC;
  const int wg = threadIdx.x / 128;
  const int stride = NC * gridDim.x;

  if (threadIdx.x == 0) {
    for (int c = 0; c < NC; ++c) {  // an empty barrier: one arrival per warp of consumer c
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
    if ((threadIdx.x & 31) == 0 && c < NC) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      uint8_t* kv = smem + L::kKv + c * L::kStage;
      int t = 0;
      for (int i = 0, w = c * gridDim.x + blockIdx.x; w < pr.n_items; ++i, w += stride) {
        const int bn = w / pr.n_blocks, r0 = (w % pr.n_blocks) * 64;
        // the item's rows once the consumer's last S of item i - 1 is in
        mbar_wait(&q_empty[c], (i & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[c], L::kQHalf);
        for (int b = 0; b < L::kBoxes; ++b)
          tma_load_3d(smem + L::kQ + c * L::kQOp + b * L::kQBox, &tq, &q_full[c], 32 * b, r0,
                      bn);
        for (int j = 0; j < pr.n_tiles; ++j, ++t) {
          const uint32_t ph = t & 1;
          mbar_wait(&k_empty[c], ph ^ 1);
          mbar_arrive_expect_tx(&k_full[c], L::kKvOp);
          for (int m = 0; m < 2; ++m)
            for (int b = 0; b < L::kBoxes; ++b)
              tma_load_4d(kv + m * L::kKvHalf + b * L::kKBox, &tk, &k_full[c], 32 * b, j * KT,
                          bn, m);
          mbar_wait(&v_empty[c], ph ^ 1);
          mbar_arrive_expect_tx(&v_full[c], L::kKvOp);
          for (int m = 0; m < 2; ++m)
            for (int b = 0; b < KT / 32; ++b)
              tma_load_4d(kv + L::kKvOp + m * L::kKvHalf + b * L::kVBox, &tv, &v_full[c],
                          j * KT + 32 * b, 0, bn, m);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 + c is consumer c
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + (lane >> 2), tg = lane & 3;
    const uint32_t base = smem_u32(smem);
    const uint32_t q_rows = base + L::kQ + cw * L::kQOp;
    float s[kS], pv[kO], o[kO];
    uint32_t ph_[kS], pl_[kS];
    int t = 0;
    for (int i = 0, w = cw * gridDim.x + blockIdx.x; w < pr.n_items; ++i, w += stride) {
      const int bn = w / pr.n_blocks, row = (w % pr.n_blocks) * 64 + r;
      mbar_wait(&q_full[cw], i & 1);
      split_q_in_place<DP>(smem + L::kQ + cw * L::kQOp, tid);
      fence_proxy_async_smem();  // the split, seen by the wgmmas
      named_bar_sync(1 + cw, 128);
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int k = 0; k < kO; ++k) o[k] = 0.f;
      for (int j = 0; j < pr.n_tiles; ++j, ++t) {
        const uint32_t ph = t & 1;
        const uint32_t kb = opaque(base) + L::kKv + cw * L::kStage;
        mbar_wait(&k_full[cw], ph);
        wgmma_fence();
        products_over_d<KT, DP / 8>(s, opaque(q_rows), L::kQBox, L::kQHalf, kb, L::kKBox,
                                    L::kKvHalf);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kS>(s);
        mbar_arrive_if(&k_empty[cw], lane == 0);
        mbar_arrive_if(&q_empty[cw], lane == 0 && j == pr.n_tiles - 1);
        // key column 8jj + 2tg + e of the tile is real while 8jj + e < lim
        // (lim >= KT before the last tile)
        const int lim = pr.sk_actual - j * KT - 2 * tg;
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
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
        for (int jj = 0; jj < KT / 8; ++jj) {
          s[4 * jj] = exp2f(s[4 * jj] - m0);
          s[4 * jj + 1] = exp2f(s[4 * jj + 1] - m0);
          s[4 * jj + 2] = exp2f(s[4 * jj + 2] - m1);
          s[4 * jj + 3] = exp2f(s[4 * jj + 3] - m1);
          r0 += s[4 * jj] + s[4 * jj + 1];
          r1 += s[4 * jj + 2] + s[4 * jj + 3];
        }
        l0 = l0 * a0 + r0;
        l1 = l1 * a1 + r1;
        to_tf32_fragments<KT / 8>(s, ph_, pl_);
        fence_regs<kS>(ph_);
        fence_regs<kS>(pl_);
        mbar_wait(&v_full[cw], ph);
        wgmma_fence();
        products_pv<DP, KT>(pv, ph_, pl_, kb + L::kKvOp, L::kKvHalf);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kO>(pv);
        mbar_arrive_if(&v_empty[cw], lane == 0);
#pragma unroll
        for (int jj = 0; jj < DP / 8; ++jj) {
          o[4 * jj] = o[4 * jj] * a0 + pv[4 * jj];
          o[4 * jj + 1] = o[4 * jj + 1] * a0 + pv[4 * jj + 1];
          o[4 * jj + 2] = o[4 * jj + 2] * a1 + pv[4 * jj + 2];
          o[4 * jj + 3] = o[4 * jj + 3] * a1 + pv[4 * jj + 3];
        }
      }
      store_rows<DP>(pr, o, l0, l1, m0, m1, bn, row, tg);
    }
  }
}

// K6a (d 64, with the log-sum-exp) and K5 / K4 at d 40 and 64
__global__ void __launch_bounds__(384, 1)
fa_f32_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdParams pr) {
  fwd_body<64, 64, 2>(tq, tk, tv, pr);
}

// K5 / K4 at d 8 and 16 (32 columns)
__global__ void __launch_bounds__(384, 1)
fa_f32_fwd_d32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const FwdParams pr) {
  fwd_body<32, 64, 2>(tq, tk, tv, pr);
}

// K5 / K4 at d 80 (96 columns, 32-key tiles)
__global__ void __launch_bounds__(384, 1)
fa_f32_fwd_d96_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const FwdParams pr) {
  fwd_body<96, 32, 2>(tq, tk, tv, pr);
}

// K5 / K4 at d 160 (one consumer, 32-key tiles)
__global__ void __launch_bounds__(256, 1)
fa_f32_fwd_d160_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const FwdParams pr) {
  fwd_body<160, 32, 1>(tq, tk, tv, pr);
}

// ------------------------------------------------------------ pre-pass
// The workspace, floats from its base: [K hi, K lo] (BN, Sk_pad, d) each,
// then [V^T hi, V^T lo] (BN, d, Sk_pad) each, every 8 keys of V^T permuted.

struct PrepParams {
  const float* k;
  const float* v;
  float* ws;
  int sk_pad, d;
};

// 64 keys of k (blockIdx.z 0) into their hi and lo, or of v (1) into their
// transposed, permuted hi and lo (d a multiple of 8, at most kMaxD)
__global__ void __launch_bounds__(256) fa_f32_fwd_prep_kernel(const PrepParams p) {
  __shared__ float tile[64][kMaxD + 1];
  const int d = p.d;
  const size_t nk = (size_t)gridDim.y * p.sk_pad * d;
  const int row0 = blockIdx.x * 64;
  const size_t off = ((size_t)blockIdx.y * p.sk_pad + row0) * d;
  const float4* src = reinterpret_cast<const float4*>((blockIdx.z == 0 ? p.k : p.v) + off);
  const int n4 = 16 * d;  // float4s in 64 rows of d
  if (blockIdx.z == 0) {
    float4* hi4 = reinterpret_cast<float4*>(p.ws + off);
    float4* lo4 = reinterpret_cast<float4*>(p.ws + nk + off);
    for (int idx = threadIdx.x; idx < n4; idx += 256) {
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
  for (int idx = threadIdx.x; idx < n4; idx += 256) {
    const float4 x = src[idx];
    const int e = 4 * idx;  // a row of d floats holds whole float4s
    float* row = &tile[e / d][e % d];
    row[0] = x.x;
    row[1] = x.y;
    row[2] = x.z;
    row[3] = x.w;
  }
  __syncthreads();
  float* tt = p.ws + 2 * nk;
  const size_t head = (size_t)blockIdx.y * d * p.sk_pad;
  for (int idx = threadIdx.x; idx < 64 * d; idx += 256) {
    const int dd = idx >> 6, pp = idx & 63;
    uint32_t h, l;
    split_tf32(tile[permuted_row(pp)][dd], h, l);
    const size_t at = head + (size_t)dd * p.sk_pad + row0 + pp;
    tt[at] = __uint_as_float(h);
    tt[nk + at] = __uint_as_float(l);
  }
}

int allow_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the allowance of dynamic shared memory, set once a kernel (K numbers it)
template <int K>
int smem_once(const void* kernel, int bytes) {
  static const int rc = allow_smem(kernel, bytes);
  return rc;
}

// the tensor maps, parameters and grid of a forward call on instance (DP,
// KT, NC); returns a cudaError_t value
template <int DP, int KT, int NC>
int prepare_fwd(CUtensorMap* maps, FwdParams& pr, int& ctas, const void* qh, const void* ws,
                void* out, void* lse, int BN, int sq_pad, int sk_actual, int sk_pad, int d) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  const size_t nk = (size_t)BN * sk_pad * d;
  const cuuint64_t qdims[3] = {(cuuint64_t)d, (cuuint64_t)sq_pad, (cuuint64_t)BN};
  const cuuint64_t qstr[2] = {(cuuint64_t)d * 4, (cuuint64_t)sq_pad * d * 4};
  const cuuint32_t qbox[3] = {32, 64, 1};
  int rc = make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, qh, 3, qdims, qstr, qbox);
  if (rc) return rc;
  const cuuint64_t kdims[4] = {(cuuint64_t)d, (cuuint64_t)sk_pad, (cuuint64_t)BN, 2};
  const cuuint64_t kstr[3] = {(cuuint64_t)d * 4, (cuuint64_t)sk_pad * d * 4, (cuuint64_t)nk * 4};
  const cuuint32_t kbox[4] = {32, KT, 1, 1};
  if ((rc = make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, 4, kdims, kstr, kbox)))
    return rc;
  const cuuint64_t vdims[4] = {(cuuint64_t)sk_pad, (cuuint64_t)d, (cuuint64_t)BN, 2};
  const cuuint64_t vstr[3] = {(cuuint64_t)sk_pad * 4, (cuuint64_t)sk_pad * d * 4,
                              (cuuint64_t)nk * 4};
  const cuuint32_t vbox[4] = {32, DP, 1, 1};
  if ((rc = make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (const float*)ws + 2 * nk, 4,
                     vdims, vstr, vbox)))
    return rc;
  pr = FwdParams{};
  pr.out = (float*)out;
  pr.lse = (float*)lse;
  pr.sq_pad = sq_pad;
  pr.sk_actual = sk_actual;
  pr.d = d;
  pr.n_blocks = sq_pad / 64;
  pr.n_items = pr.n_blocks * BN;
  pr.n_tiles = (sk_actual + KT - 1) / KT;
  ctas = (pr.n_items + NC - 1) / NC;  // NC consumers a CTA
  if (ctas > sms) ctas = sms;
  return 0;
}

}  // namespace

// Shapes (checked by the Python wrapper): qh, out (BN, sq_pad, d) fp32,
// lse (BN, sq_pad) fp32; kh, vh (BN, sk_pad, d) fp32; d a multiple of 8 up
// to 160; sq_pad and sk_pad multiples of 64; 1 <= sk_actual <= sk_pad; ws
// holds 4 BN sk_pad d floats (the layout above); every pointer 16-byte
// aligned.

// the pre-pass of a forward call into ws
extern "C" int fg_flash_fwd_prep_f32(const void* kh, const void* vh, void* ws, int BN,
                                     int sk_pad, int d, void* stream) {
  if (d % 8 || d < 8 || d > kMaxD) return (int)cudaErrorInvalidValue;
  PrepParams p = {};
  p.k = (const float*)kh;
  p.v = (const float*)vh;
  p.ws = (float*)ws;
  p.sk_pad = sk_pad;
  p.d = d;
  fa_f32_fwd_prep_kernel<<<dim3(sk_pad / 64, BN, 2), 256, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// the forward from q and the pre-pass's workspace: with lse (K6a, d 64
// only), or without (K5, K4's max and masked forms, lse null)
extern "C" int fg_flash_fwd_f32_tc(const void* qh, const void* ws, void* out, void* lse, int BN,
                                   int sq_pad, int sk_actual, int sk_pad, int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d % 8 || d < 8 || d > kMaxD || (lse != nullptr && d != 64))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  FwdParams pr;
  int ctas = 0, rc;
#define FG_FWD(K, kernel, DP, KT, NC)                                                       \
  if ((rc = smem_once<K>((const void*)kernel, FwdSmem<DP, KT, NC>::kBytes))) return rc;     \
  if ((rc = prepare_fwd<DP, KT, NC>(m, pr, ctas, qh, ws, out, lse, BN, sq_pad, sk_actual,  \
                                    sk_pad, d)))                                            \
    return rc;                                                                              \
  kernel<<<ctas, 128 * (NC + 1), FwdSmem<DP, KT, NC>::kBytes, s>>>(m[0], m[1], m[2], pr);  \
  return (int)cudaGetLastError();
  if (d <= 32) {  // lse is null here: K6a takes d 64 only
    FG_FWD(0, fa_f32_fwd_d32_kernel, 32, 64, 2)
  }
  if (d <= 64) {
    FG_FWD(1, fa_f32_fwd_tc_kernel, 64, 64, 2)
  }
  if (d <= 96) {
    FG_FWD(2, fa_f32_fwd_d96_kernel, 96, 32, 2)
  }
  FG_FWD(3, fa_f32_fwd_d160_kernel, 160, 32, 1)
#undef FG_FWD
}

// dynamic shared memory of the forward's instances, in bytes (printed by
// chip_smoke.py): 0 the 64-column ones (K6a's too), 1 the 32-column, 2 the
// 96-column, 3 the 160-column
extern "C" int fg_flash_f32_smem_bytes(int which) {
  return which == 0   ? FwdSmem<64, 64, 2>::kBytes
         : which == 1 ? FwdSmem<32, 64, 2>::kBytes
         : which == 2 ? FwdSmem<96, 32, 2>::kBytes
                      : FwdSmem<160, 32, 1>::kBytes;
}
