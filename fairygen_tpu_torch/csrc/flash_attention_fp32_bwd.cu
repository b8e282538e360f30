// K6b and K6c in fp32 at head dim 64 on Hopper's tensor cores (sm_90a): the
// two backward kernels of flash attention with a gradient on head-major
// fp32 q/k/v/dO (B*N, S_pad, 64), the masked Style-DoRA finetune of the
// fp32 SDXL UNet (its heads are 64 wide).  K6a's fp32 form stays in
// csrc/flash_attention_fp32.cu.
//
// Replaces the TPU kernels fairygen_tpu/ops/flash_attention.py, run on fp32
// inputs:
//   K6b _fa_bwd_dq_kernel  (:295)  dQ = f * sum_j [P o (dP - delta)] K_j
//   K6c _fa_bwd_dkv_kernel (:329)  dV = sum_i P^T dO_i,
//                                  dK = sum_i [P o (dP - delta)]^T Q_i / log2(e)
// Contract (csrc/flash_attention_fp32.cu's): q carries hd^-1/2 * log2(e), so
// P = exp2(S - lse) with S = Q K^T; key columns >= sk_actual give P = 0 in
// K6b; lse and delta = sum_d dO * O are one fp32 value a row; S_pad is a
// multiple of 64 and rows past the sequence are zero.  K6b writes every row
// below Sq_pad; K6c skips queries >= sq (whatever the padded rows of lse and
// delta hold), writes every row below Sk_pad, and key rows >= sk_actual come
// out exactly 0.  No atomics: every output element is summed by one CTA (or,
// with a split query loop, by one CTA a split and then one thread of the
// reduce pass in a fixed order), so the same inputs give the same bits.
//
// fp32 accuracy on the tensor cores (3xTF32).  wgmma multiplies TF32 (10
// mantissa bits).  Each operand x is split as hi = rna_tf32(x), lo =
// rna_tf32(x - hi) (x - hi is exact in fp32), and each product A B is taken
// as lo_A hi_B + hi_A lo_B + hi_A hi_B, three m64nNk8.f32.tf32.tf32 passes
// into one fp32 accumulator: the dropped lo_A lo_B and the rounding of lo
// are below 2^-21 relative.  The tensor cores' fp32 sums truncate, so the
// long reductions (dQ over keys, dK and dV over queries) start a fresh
// accumulator every tile and add it into registers with round-to-nearest
// FADDs.  The logits, exp2 (exp2f, about 2 ulp), P, dS and every sum but
// the products stay fp32.
//
// Operands.  For .tf32 wgmma takes no transpose: A and B in shared memory
// are both K-major.  S = Q K^T and dP = dO V^T reduce over d, so Q, dO, K
// and V serve as they lie.  dQ = dS K (K6b) needs K^T, dV = P^T dO and dK =
// dS^T Q (K6c) need dO^T and Q^T; dS and P^T are the register A operand,
// taken straight from the S accumulator, whose thread holds columns 2t and
// 2t + 1 of each 8-wide k-step where the TF32 A fragment wants t and t + 4.
// So one pre-pass kernel a call (fa_f32_bwd_prep_kernel) writes the hi and
// lo of q, dO, k and v and the hi and lo of the transposed operands into a
// workspace, the transposed ones with each 8 keys (queries) permuted as 0,
// 2, 4, 6, 1, 3, 5, 7, which matches the accumulator's order; the TMA then
// loads every operand into 128-byte-swizzled boxes of 32 fp32 columns.
//
// Bound on the H100: operations.  6 (K6b) and 8 (K6c) x BN Sq Sk 64 flops
// at 494.7 / 3 TFLOP/s (three TF32 passes), or the bytes each input is
// read and each output written once at 3.35 TB/s where larger (the 77-key
// shapes).  The pre-pass's copies are the design's cost, not the work.
// Design (csrc/flash_attention_bwd.cu's, K6b and K6c in bf16):
//   - persistent: one CTA of 384 threads on each SM walks the items
//     blockIdx.x, blockIdx.x + gridDim.x, ...; warpgroup 0 is the producer
//     (one thread issues every TMA load), warpgroups 1 and 2 the consumers,
//     each owning 64 rows of the item;
//   - K6b: an item is 128 query rows of one head; Q and dO (hi and lo, 128
//     KB) stay for the item; K, V and K^T stream in 64-key tiles, each in
//     its own buffer with its own full / empty mbarriers, so the next K
//     loads while this tile's dP and dQ run (the hi/lo split fills the
//     shared memory: 225 KB of 227).  Per tile, each consumer: S and dP
//     (m64n64k8, both operands from shared memory), P = exp2(S - lse)
//     while dP is on the tensor cores, dS (key columns >= sk_actual
//     selected to 0), its hi / lo as the register A operand of dQ (B = K^T);
//   - K6c: an item is 128 keys of one head and one split of the query
//     loop; K and V (hi and lo, 128 KB) stay for the item; Q, dO (with lse,
//     delta), dO^T and Q^T stream in 32-query tiles, each in its own buffer.
//     Per tile, each consumer (64 keys): S^T = K Q^T and dP^T = V dO^T
//     (m64n32k8), P^T = exp2(S^T - lse) (lse = +inf at queries >= sq),
//     dS^T, then dV += P^T dO and dK += dS^T Q (m64n64k8, register A).
//     The wrapper splits the query loop over CTAs where rounds of items
//     would leave SMs idle (dkv_splits in ops/flash_attention.py: at 77
//     keys a head is one item, at 20 x 1024 keys 160 items are 1.2
//     rounds); each split writes fp32 partial dK and dV to a workspace and
//     fa_f32_dkv_reduce_kernel sums them in split order;
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
constexpr float kInvLog2e = 0.6931471805599453f;

// rows `row` and row + 8 of a (rows, 64) fp32 output (from element row0 *
// 64) = a 64 x 64 accumulator (wgmma layout) x scale; rows >= `rows` are not
// stored, rows >= `keep` are stored as 0
__device__ __forceinline__ void store_rows(float* out, const float* acc, float scale,
                                           size_t row0, int row, int rows, int keep, int tg) {
  float2* dst = reinterpret_cast<float2*>(out + (row0 + row) * kD) + tg;
  if (row < rows) {
    const bool ok = row < keep;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      dst[4 * j] = ok ? make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale)
                      : make_float2(0.f, 0.f);
  }
  if (row + 8 < rows) {
    const bool ok = row + 8 < keep;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      dst[8 * (kD / 2) + 4 * j] = ok ? make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale)
                                     : make_float2(0.f, 0.f);
  }
}

// ------------------------------------------------------------ workspace
// Floats from the base: [q hi, q lo, dO hi, dO lo] (BN, Sq_pad, 64) each,
// then [k hi, k lo, v hi, v lo] (BN, Sk_pad, 64), then the transposed
// operands (BN, 64, S_pad), each 8 rows permuted: K6b [K^T hi, K^T lo],
// K6c [Q^T hi, Q^T lo, dO^T hi, dO^T lo].

struct Ws {
  size_t nq, nk;
  __host__ __device__ size_t kv() const { return 4 * nq; }
  __host__ __device__ size_t t() const { return 4 * nq + 4 * nk; }
};

struct PrepParams {
  const float* src[4];  // q, dO, k, v
  float* ws;
  int which;  // 0: K6b (K^T), 1: K6c (Q^T, dO^T)
  int sq_pad, sk_pad;
};

// the pre-pass: a 64 x 64 tile of one of q, dO, k, v (blockIdx.z) into its
// hi and lo, and (for the operands the kernel transposes) its transposed,
// permuted hi and lo
__global__ void __launch_bounds__(256) fa_f32_bwd_prep_kernel(const PrepParams p, int BN) {
  __shared__ float tile[64][65];
  const int z = blockIdx.z;
  const int rows = z < 2 ? p.sq_pad : p.sk_pad;
  const int row0 = blockIdx.x * 64;
  if (row0 >= rows) return;
  Ws ws{(size_t)BN * p.sq_pad * kD, (size_t)BN * p.sk_pad * kD};
  const size_t n = z < 2 ? ws.nq : ws.nk;
  float* nat = p.ws + (z < 2 ? 0 : ws.kv()) + (z & 1) * 2 * n;
  const size_t off = ((size_t)blockIdx.y * rows + row0) * kD;
  // a select, not p.src[z]: an index into the parameters would copy them
  // to the stack
  const float* in = z == 0 ? p.src[0] : z == 1 ? p.src[1] : z == 2 ? p.src[2] : p.src[3];
  const float4* src = reinterpret_cast<const float4*>(in + off);
  float4* hi4 = reinterpret_cast<float4*>(nat + off);
  float4* lo4 = reinterpret_cast<float4*>(nat + n + off);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * 256 + threadIdx.x;
    const float4 x = src[idx];
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(xs[e], h[e], l[e]);
      tile[idx >> 4][(idx & 15) * 4 + e] = xs[e];
    }
    hi4[idx] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                           __uint_as_float(h[3]));
    lo4[idx] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                           __uint_as_float(l[3]));
  }
  const int slot = p.which == 0 ? (z == 2 ? 0 : -1) : (z < 2 ? z : -1);
  if (slot < 0) return;
  __syncthreads();
  float* tt = p.ws + ws.t() + (size_t)slot * 2 * n;
  const size_t head = (size_t)blockIdx.y * kD * rows;
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int idx = it * 256 + threadIdx.x;
    const int d = idx >> 6, pp = idx & 63;
    uint32_t h, l;
    split_tf32(tile[permuted_row(pp)][d], h, l);
    const size_t at = head + (size_t)d * rows + row0 + pp;
    tt[at] = __uint_as_float(h);
    tt[n + at] = __uint_as_float(l);
  }
}

// the reduce pass: dK (and dV) = the splits' partials summed in split order
__global__ void __launch_bounds__(256) fa_f32_dkv_reduce_kernel(const float4* part, float4* dk,
                                                               float4* dv, int n_split,
                                                               int n4) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n4) return;
  const int which = i >= n4, e = i - which * n4;
  float4 s = part[(size_t)which * n4 + e];
  for (int sp = 1; sp < n_split; ++sp) {
    const float4 x = part[((size_t)2 * sp + which) * n4 + e];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  (which ? dv : dk)[e] = s;
}

// ---------------------------------------------------------------- K6b

struct DqSmem {
  static constexpr int kQBox = 128 * 128;  // 32 fp32 columns of 128 rows
  static constexpr int kQ = 2 * kQBox;     // 128 rows x 64, 32 KB
  static constexpr int kKBox = 64 * 128;   // 32 fp32 columns of 64 rows
  static constexpr int kK = 2 * kKBox;     // 64 rows x 64, 16 KB
  static constexpr int kQd = 0;            // Q hi, Q lo, dO hi, dO lo
  static constexpr int kKt = 4 * kQ;       // K hi, K lo
  static constexpr int kVt = kKt + 2 * kK;  // V hi, V lo
  static constexpr int kTt = kVt + 2 * kK;  // K^T hi, K^T lo (64 d rows x 64 keys)
  static constexpr int kLse = kTt + 2 * kK;
  static constexpr int kDelta = kLse + 128 * 4;
  static constexpr int kBar = kDelta + 128 * 4;
  static constexpr int kBytes = kBar + 8 * 8 + 1024;  // + 1024-alignment slack
};

struct DqParams {
  int sq_pad, sk_actual;
  int n_blocks, n_items, n_tiles;  // 128-row q blocks a head, items, 64-key tiles
  float dq_factor;
  float* dq;
};

__global__ void __launch_bounds__(kThreads, 1)
fa_f32_dq_tc_kernel(const __grid_constant__ CUtensorMap tqd, const __grid_constant__ CUtensorMap tkv,
                    const __grid_constant__ CUtensorMap tt,
                    const __grid_constant__ CUtensorMap tlse,
                    const __grid_constant__ CUtensorMap tdelta, const DqParams pr) {
  using L = DqSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* qd_full = bars;  // Q, dO, lse and delta of an item
  uint64_t* qd_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* k_empty = bars + 3;
  uint64_t* v_full = bars + 4;
  uint64_t* v_empty = bars + 5;
  uint64_t* t_full = bars + 6;
  uint64_t* t_empty = bars + 7;
  const int mine = (pr.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 8; b += 2) {
      mbar_init(&bars[b], 1);
      mbar_init(&bars[b + 1], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tqd);
      prefetch_map(&tkv);
      prefetch_map(&tt);
      prefetch_map(&tlse);
      prefetch_map(&tdelta);
      int t = 0;
      for (int i = 0; i < mine; ++i) {
        const int w = blockIdx.x + i * gridDim.x;
        const int r0 = (w % pr.n_blocks) * 128, bn = w / pr.n_blocks;
        // the item's rows once both consumers' last dP of item i - 1 is in
        mbar_wait(qd_empty, (i & 1) ^ 1);
        mbar_arrive_expect_tx(qd_full, 4 * L::kQ + 2 * 128 * 4);
        for (int m = 0; m < 4; ++m)
          for (int h = 0; h < 2; ++h)
            tma_load_4d(smem + L::kQd + m * L::kQ + h * L::kQBox, &tqd, qd_full, 32 * h, r0, bn,
                        m);
        tma_load_2d(smem + L::kLse, &tlse, qd_full, r0, bn);
        tma_load_2d(smem + L::kDelta, &tdelta, qd_full, r0, bn);
        for (int j = 0; j < pr.n_tiles; ++j, ++t) {
          const uint32_t ph = t & 1;
          mbar_wait(k_empty, ph ^ 1);
          mbar_arrive_expect_tx(k_full, 2 * L::kK);
          for (int m = 0; m < 2; ++m)
            for (int h = 0; h < 2; ++h)
              tma_load_4d(smem + L::kKt + m * L::kK + h * L::kKBox, &tkv, k_full, 32 * h, j * 64,
                          bn, m);
          mbar_wait(v_empty, ph ^ 1);
          mbar_arrive_expect_tx(v_full, 2 * L::kK);
          for (int m = 0; m < 2; ++m)
            for (int h = 0; h < 2; ++h)
              tma_load_4d(smem + L::kVt + m * L::kK + h * L::kKBox, &tkv, v_full, 32 * h, j * 64,
                          bn, 2 + m);
          mbar_wait(t_empty, ph ^ 1);
          mbar_arrive_expect_tx(t_full, 2 * L::kK);
          for (int m = 0; m < 2; ++m)
            for (int h = 0; h < 2; ++h)
              tma_load_4d(smem + L::kTt + m * L::kK + h * L::kKBox, &tt, t_full, j * 64 + 32 * h,
                          0, bn, m);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 the item's rows 0..63, warpgroup 2 64..127
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + (lane >> 2), tg = lane & 3;
    const int qr = cw * 64 + r;  // this thread's first row within the item
    const uint32_t base = smem_u32(smem);
    const uint32_t q_rows = base + L::kQd + cw * 64 * 128;  // this warpgroup's Q hi rows
    const uint32_t do_rows = q_rows + 2 * L::kQ;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
    const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta);
    float dq[32], s[32], dp[32], acc[32];
    uint32_t ah[32], al[32];
    int t = 0;
    for (int i = 0; i < mine; ++i) {
      const int w = blockIdx.x + i * gridDim.x;
      const int r0 = (w % pr.n_blocks) * 128, bn = w / pr.n_blocks;
      mbar_wait(qd_full, i & 1);
      const float lse0 = lse_s[qr], lse1 = lse_s[qr + 8];
      const float dl0 = delta_s[qr], dl1 = delta_s[qr + 8];
#pragma unroll
      for (int k = 0; k < 32; ++k) dq[k] = 0.f;
      for (int j = 0; j < pr.n_tiles; ++j, ++t) {
        const uint32_t ph = t & 1;
        mbar_wait(k_full, ph);
        wgmma_fence();
        products_over_d<64>(s, q_rows, L::kQBox, L::kQ, base + L::kKt, L::kKBox, L::kK);
        wgmma_commit();
        mbar_wait(v_full, ph);
        products_over_d<64>(dp, do_rows, L::kQBox, L::kQ, base + L::kVt, L::kKBox, L::kK);
        wgmma_commit();
        wgmma_wait<1>();  // S is in; dP still runs
        fence_regs<32>(s);
        mbar_arrive_if(k_empty, lane == 0);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          s[4 * jj] = exp2f(s[4 * jj] - lse0);
          s[4 * jj + 1] = exp2f(s[4 * jj + 1] - lse0);
          s[4 * jj + 2] = exp2f(s[4 * jj + 2] - lse1);
          s[4 * jj + 3] = exp2f(s[4 * jj + 3] - lse1);
        }
        wgmma_wait<0>();
        fence_regs<32>(dp);
        mbar_arrive_if(v_empty, lane == 0);
        mbar_arrive_if(qd_empty, lane == 0 && j == pr.n_tiles - 1);
        // dS = P o (dP - delta), 0 at key columns >= sk_actual (lim >= 64
        // before the last tile)
        const int lim = pr.sk_actual - j * 64 - 2 * tg;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool out = 8 * jj + e >= lim;
            const float x0 = s[4 * jj + e] * (dp[4 * jj + e] - dl0);
            const float x1 = s[4 * jj + 2 + e] * (dp[4 * jj + 2 + e] - dl1);
            s[4 * jj + e] = out ? 0.f : x0;
            s[4 * jj + 2 + e] = out ? 0.f : x1;
          }
        to_tf32_fragments<8>(s, ah, al);
        fence_regs<32>(ah);
        fence_regs<32>(al);
        mbar_wait(t_full, ph);
        wgmma_fence();
        products_over_rows<8>(acc, ah, al, base + L::kTt, L::kK);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(acc);
        mbar_arrive_if(t_empty, lane == 0);
#pragma unroll
        for (int k = 0; k < 32; ++k) dq[k] += acc[k];
      }
      store_rows(pr.dq, dq, pr.dq_factor, (size_t)bn * pr.sq_pad, r0 + qr, pr.sq_pad, pr.sq_pad,
                 tg);
    }
  }
}

// ---------------------------------------------------------------- K6c

constexpr int kQTile = 32;  // queries a K6c tile

struct DkvSmem {
  static constexpr int kKBox = 128 * 128;  // 32 fp32 columns of 128 keys
  static constexpr int kK = 2 * kKBox;     // 128 keys x 64, 32 KB
  static constexpr int kKv = 0;            // K hi, K lo, V hi, V lo
  static constexpr int kQBox = kQTile * 128;  // 32 fp32 columns of 32 queries
  static constexpr int kQ = 2 * kQBox;        // 32 queries x 64, 8 KB
  static constexpr int kQt = 4 * kK;          // Q hi, Q lo
  static constexpr int kDOt = kQt + 2 * kQ;   // dO hi, dO lo
  static constexpr int kTBox = 64 * 128;      // a transposed tile: 64 d rows x 32 queries
  static constexpr int kDOT = kDOt + 2 * kQ;  // dO^T hi, dO^T lo
  static constexpr int kQT = kDOT + 2 * kTBox;  // Q^T hi, Q^T lo
  static constexpr int kLse = kQT + 2 * kTBox;
  static constexpr int kDelta = kLse + kQTile * 4;
  static constexpr int kBar = kDelta + kQTile * 4;
  static constexpr int kBytes = kBar + 10 * 8 + 1024;  // + 1024-alignment slack
};

struct DkvParams {
  int sq, sk_actual, sk_pad;
  int n_kb, BN, n_items;  // 128-key blocks a head, heads, items (x splits)
  int n_qt, tiles_per_split, n_split;
  float* dk;
  float* dv;
  float* part;  // (n_split, 2, BN, Sk_pad, 64) partials when n_split > 1
};

struct DkvItem {
  int k0, bn, split, j0, j1;
};

__device__ __forceinline__ DkvItem dkv_item(int w, const DkvParams& pr) {
  DkvItem it;
  it.k0 = (w % pr.n_kb) * 128;
  const int rest = w / pr.n_kb;
  it.bn = rest % pr.BN;
  it.split = rest / pr.BN;
  it.j0 = it.split * pr.tiles_per_split;
  it.j1 = min(it.j0 + pr.tiles_per_split, pr.n_qt);
  return it;
}

__global__ void __launch_bounds__(kThreads, 1)
fa_f32_dkv_tc_kernel(const __grid_constant__ CUtensorMap tqd,
                     const __grid_constant__ CUtensorMap tkv,
                     const __grid_constant__ CUtensorMap tt,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdelta, const DkvParams pr) {
  using L = DkvSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bars;  // K and V of an item
  uint64_t* kv_empty = bars + 1;
  uint64_t* q_full = bars + 2;  // Q and lse of a tile
  uint64_t* q_empty = bars + 3;
  uint64_t* do_full = bars + 4;  // dO and delta
  uint64_t* do_empty = bars + 5;
  uint64_t* dot_full = bars + 6;  // dO^T
  uint64_t* dot_empty = bars + 7;
  uint64_t* qt_full = bars + 8;  // Q^T
  uint64_t* qt_empty = bars + 9;
  const int mine = (pr.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 10; b += 2) {
      mbar_init(&bars[b], 1);
      mbar_init(&bars[b + 1], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load; an item whose keys all
    // lie at or past sk_actual loads nothing
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tqd);
      prefetch_map(&tkv);
      prefetch_map(&tt);
      prefetch_map(&tlse);
      prefetch_map(&tdelta);
      int t = 0, c = 0;
      for (int i = 0; i < mine; ++i) {
        const DkvItem it = dkv_item(blockIdx.x + i * gridDim.x, pr);
        if (it.k0 >= pr.sk_actual) continue;
        mbar_wait(kv_empty, (c & 1) ^ 1);
        ++c;
        mbar_arrive_expect_tx(kv_full, 4 * L::kK);
        for (int m = 0; m < 4; ++m)
          for (int h = 0; h < 2; ++h)
            tma_load_4d(smem + L::kKv + m * L::kK + h * L::kKBox, &tkv, kv_full, 32 * h, it.k0,
                        it.bn, m);
        for (int j = it.j0; j < it.j1; ++j, ++t) {
          const uint32_t ph = t & 1;
          const int q0 = j * kQTile;
          mbar_wait(q_empty, ph ^ 1);
          mbar_arrive_expect_tx(q_full, 2 * L::kQ + kQTile * 4);
          for (int m = 0; m < 2; ++m)
            for (int h = 0; h < 2; ++h)
              tma_load_4d(smem + L::kQt + m * L::kQ + h * L::kQBox, &tqd, q_full, 32 * h, q0,
                          it.bn, m);
          tma_load_2d(smem + L::kLse, &tlse, q_full, q0, it.bn);
          mbar_wait(do_empty, ph ^ 1);
          mbar_arrive_expect_tx(do_full, 2 * L::kQ + kQTile * 4);
          for (int m = 0; m < 2; ++m)
            for (int h = 0; h < 2; ++h)
              tma_load_4d(smem + L::kDOt + m * L::kQ + h * L::kQBox, &tqd, do_full, 32 * h, q0,
                          it.bn, 2 + m);
          tma_load_2d(smem + L::kDelta, &tdelta, do_full, q0, it.bn);
          mbar_wait(dot_empty, ph ^ 1);
          mbar_arrive_expect_tx(dot_full, 2 * L::kTBox);
          for (int m = 0; m < 2; ++m)
            tma_load_4d(smem + L::kDOT + m * L::kTBox, &tt, dot_full, q0, 0, it.bn, 2 + m);
          mbar_wait(qt_empty, ph ^ 1);
          mbar_arrive_expect_tx(qt_full, 2 * L::kTBox);
          for (int m = 0; m < 2; ++m)
            tma_load_4d(smem + L::kQT + m * L::kTBox, &tt, qt_full, q0, 0, it.bn, m);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 the item's keys 0..63, warpgroup 2 64..127
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + (lane >> 2), tg = lane & 3;
    const uint32_t base = smem_u32(smem);
    const uint32_t k_rows = base + L::kKv + cw * 64 * 128;  // this warpgroup's K hi keys
    const uint32_t v_rows = k_rows + 2 * L::kK;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
    const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta);
    float dk[32], dv[32], acc_k[32], acc_v[32], st[16], dpt[16];
    uint32_t ph_[16], pl_[16], dh_[16], dl_[16];
    int t = 0, c = 0;
    for (int i = 0; i < mine; ++i) {
      const DkvItem it = dkv_item(blockIdx.x + i * gridDim.x, pr);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        dk[k] = 0.f;
        dv[k] = 0.f;
      }
      if (it.k0 < pr.sk_actual) {
        mbar_wait(kv_full, c & 1);
        ++c;
        for (int j = it.j0; j < it.j1; ++j, ++t) {
          const uint32_t ph = t & 1;
          const uint32_t b = opaque(base);
          mbar_wait(q_full, ph);
          wgmma_fence();
          products_over_d<kQTile>(st, opaque(k_rows), L::kKBox, L::kK, b + L::kQt, L::kQBox,
                                  L::kQ);
          wgmma_commit();
          mbar_wait(do_full, ph);
          products_over_d<kQTile>(dpt, opaque(v_rows), L::kKBox, L::kK, b + L::kDOt, L::kQBox,
                                  L::kQ);
          wgmma_commit();
          // query column 8jj + 2tg + e of the tile is real while 8jj + e < lim
          const int lim = pr.sq - j * kQTile - 2 * tg;
          wgmma_wait<1>();  // S^T is in; dP^T still runs
          fence_regs<16>(st);
          float l[8];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float2 x = *reinterpret_cast<const float2*>(lse_s + 8 * jj + 2 * tg);
            l[2 * jj] = 8 * jj < lim ? x.x : INFINITY;
            l[2 * jj + 1] = 8 * jj + 1 < lim ? x.y : INFINITY;
          }
          mbar_arrive_if(q_empty, lane == 0);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            st[4 * jj] = exp2f(st[4 * jj] - l[2 * jj]);
            st[4 * jj + 1] = exp2f(st[4 * jj + 1] - l[2 * jj + 1]);
            st[4 * jj + 2] = exp2f(st[4 * jj + 2] - l[2 * jj]);
            st[4 * jj + 3] = exp2f(st[4 * jj + 3] - l[2 * jj + 1]);
          }
          wgmma_wait<0>();
          fence_regs<16>(dpt);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float2 x = *reinterpret_cast<const float2*>(delta_s + 8 * jj + 2 * tg);
            l[2 * jj] = 8 * jj < lim ? x.x : 0.f;
            l[2 * jj + 1] = 8 * jj + 1 < lim ? x.y : 0.f;
          }
          mbar_arrive_if(do_empty, lane == 0);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dpt[4 * jj] = st[4 * jj] * (dpt[4 * jj] - l[2 * jj]);
            dpt[4 * jj + 1] = st[4 * jj + 1] * (dpt[4 * jj + 1] - l[2 * jj + 1]);
            dpt[4 * jj + 2] = st[4 * jj + 2] * (dpt[4 * jj + 2] - l[2 * jj]);
            dpt[4 * jj + 3] = st[4 * jj + 3] * (dpt[4 * jj + 3] - l[2 * jj + 1]);
          }
          to_tf32_fragments<4>(st, ph_, pl_);
          to_tf32_fragments<4>(dpt, dh_, dl_);
          fence_regs<16>(ph_);
          fence_regs<16>(pl_);
          fence_regs<16>(dh_);
          fence_regs<16>(dl_);
          mbar_wait(dot_full, ph);
          wgmma_fence();
          products_over_rows<4>(acc_v, ph_, pl_, opaque(base) + L::kDOT, L::kTBox);
          wgmma_commit();
          mbar_wait(qt_full, ph);
          products_over_rows<4>(acc_k, dh_, dl_, opaque(base) + L::kQT, L::kTBox);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<32>(acc_v);
          fence_regs<32>(acc_k);
          mbar_arrive_if(dot_empty, lane == 0);
          mbar_arrive_if(qt_empty, lane == 0);
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            dv[k] += acc_v[k];
            dk[k] += acc_k[k];
          }
        }
        mbar_arrive_if(kv_empty, lane == 0);
      }
      const int row = it.k0 + cw * 64 + r;
      const size_t n = (size_t)pr.BN * pr.sk_pad * kD;
      float* out_k = pr.n_split > 1 ? pr.part + (size_t)2 * it.split * n : pr.dk;
      float* out_v = pr.n_split > 1 ? pr.part + ((size_t)2 * it.split + 1) * n : pr.dv;
      const size_t row0 = (size_t)it.bn * pr.sk_pad;
      store_rows(out_k, dk, kInvLog2e, row0, row, pr.sk_pad, pr.sk_actual, tg);
      store_rows(out_v, dv, 1.f, row0, row, pr.sk_pad, pr.sk_actual, tg);
    }
  }
}

// ---------------------------------------------------------------- host

int allow_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the five maps of a backward kernel over the workspace `ws`: the q side's
// four natural operands (64, Sq_pad, BN, 4) in boxes of 32 columns x q_box
// rows, the k side's (64, Sk_pad, BN, 4) in boxes of 32 x k_box, the
// transposed operands (S_pad, 64, BN, n_t) of the side t_rows names in
// boxes of 32 x 64, lse and delta (Sq_pad, BN) in boxes of q_box
int make_maps(CUtensorMap* maps, const float* ws, const Ws& w, const void* lse,
              const void* delta, int BN, int sq_pad, int sk_pad, int q_box, int k_box,
              int t_rows, int n_t) {
  const cuuint64_t qdims[4] = {kD, (cuuint64_t)sq_pad, (cuuint64_t)BN, 4};
  const cuuint64_t qstr[3] = {kD * 4, (cuuint64_t)sq_pad * kD * 4, (cuuint64_t)w.nq * 4};
  const cuuint32_t qbox[4] = {32, (cuuint32_t)q_box, 1, 1};
  int rc = make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, 4, qdims, qstr, qbox);
  if (rc) return rc;
  const cuuint64_t kdims[4] = {kD, (cuuint64_t)sk_pad, (cuuint64_t)BN, 4};
  const cuuint64_t kstr[3] = {kD * 4, (cuuint64_t)sk_pad * kD * 4, (cuuint64_t)w.nk * 4};
  const cuuint32_t kbox[4] = {32, (cuuint32_t)k_box, 1, 1};
  if ((rc = make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws + w.kv(), 4, kdims, kstr,
                     kbox)))
    return rc;
  const size_t n_side = (size_t)BN * t_rows * kD;
  const cuuint64_t tdims[4] = {(cuuint64_t)t_rows, kD, (cuuint64_t)BN, (cuuint64_t)n_t};
  const cuuint64_t tstr[3] = {(cuuint64_t)t_rows * 4, (cuuint64_t)t_rows * kD * 4,
                              (cuuint64_t)n_side * 4};
  const cuuint32_t tbox[4] = {32, kD, 1, 1};
  if ((rc = make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws + w.t(), 4, tdims, tstr,
                     tbox)))
    return rc;
  const cuuint32_t rbox[2] = {(cuuint32_t)q_box, 1};
  const cuuint64_t rdims[2] = {(cuuint64_t)sq_pad, (cuuint64_t)BN};
  const cuuint64_t rstr[1] = {(cuuint64_t)sq_pad * 4};
  if ((rc = make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, 2, rdims, rstr, rbox,
                     CU_TENSOR_MAP_SWIZZLE_NONE)))
    return rc;
  return make_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, delta, 2, rdims, rstr, rbox,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

// Shapes (checked by the Python wrappers): qh, doh (BN, sq_pad, 64) fp32;
// kh, vh, dk, dv (BN, sk_pad, 64) fp32; lse, delta (BN, sq_pad) fp32;
// sq_pad and sk_pad multiples of 64; 1 <= sk_actual <= sk_pad and 1 <= sq
// <= sq_pad; ws holds 4 nq + 4 nk + (2 nk for K6b, 4 nq for K6c) floats,
// nq = BN sq_pad 64 and nk = BN sk_pad 64 (the layout above); every pointer
// 16-byte aligned.

// the pre-pass of a K6b (which = 0) or K6c (1) call into ws
extern "C" int fg_flash_bwd_prep_f32(const void* qh, const void* kh, const void* vh,
                                     const void* doh, void* ws, int which, int BN, int sq_pad,
                                     int sk_pad, void* stream) {
  PrepParams p = {};
  p.src[0] = (const float*)qh;
  p.src[1] = (const float*)doh;
  p.src[2] = (const float*)kh;
  p.src[3] = (const float*)vh;
  p.ws = (float*)ws;
  p.which = which;
  p.sq_pad = sq_pad;
  p.sk_pad = sk_pad;
  const int rows = sq_pad > sk_pad ? sq_pad : sk_pad;
  fa_f32_bwd_prep_kernel<<<dim3(rows / 64, BN, 4), 256, 0, (cudaStream_t)stream>>>(p, BN);
  return (int)cudaGetLastError();
}

extern "C" int fg_flash_bwd_dq_f32_tc(const void* ws, const void* lse, const void* delta,
                                      void* dq, float dq_factor, int BN, int sq_pad,
                                      int sk_actual, int sk_pad, void* stream) {
  static int rc_smem = allow_smem((const void*)fa_f32_dq_tc_kernel, DqSmem::kBytes);
  if (rc_smem) return rc_smem;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  const Ws w{(size_t)BN * sq_pad * kD, (size_t)BN * sk_pad * kD};
  CUtensorMap maps[5];
  int rc = make_maps(maps, (const float*)ws, w, lse, delta, BN, sq_pad, sk_pad, 128, 64, sk_pad,
                     2);
  if (rc) return rc;
  DqParams pr = {};
  pr.sq_pad = sq_pad;
  pr.sk_actual = sk_actual;
  pr.n_blocks = (sq_pad + 127) / 128;
  pr.n_items = pr.n_blocks * BN;
  pr.n_tiles = (sk_actual + 63) / 64;
  pr.dq_factor = dq_factor;
  pr.dq = (float*)dq;
  fa_f32_dq_tc_kernel<<<pr.n_items < sms ? pr.n_items : sms, kThreads, DqSmem::kBytes,
                        (cudaStream_t)stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], pr);
  return (int)cudaGetLastError();
}

// n_split > 1: the query loop in n_split ranges of tiles_per_split 32-query
// tiles, fp32 partials into part (n_split, 2, BN, sk_pad, 64), to be summed
// by fg_flash_bwd_dkv_reduce_f32
extern "C" int fg_flash_bwd_dkv_f32_tc(const void* ws, const void* lse, const void* delta,
                                       void* dk, void* dv, void* part, int n_split,
                                       int tiles_per_split, int BN, int sq, int sq_pad,
                                       int sk_actual, int sk_pad, void* stream) {
  static int rc_smem = allow_smem((const void*)fa_f32_dkv_tc_kernel, DkvSmem::kBytes);
  if (rc_smem) return rc_smem;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  const Ws w{(size_t)BN * sq_pad * kD, (size_t)BN * sk_pad * kD};
  CUtensorMap maps[5];
  int rc = make_maps(maps, (const float*)ws, w, lse, delta, BN, sq_pad, sk_pad, kQTile, 128,
                     sq_pad, 4);
  if (rc) return rc;
  DkvParams pr = {};
  pr.sq = sq;
  pr.sk_actual = sk_actual;
  pr.sk_pad = sk_pad;
  pr.n_kb = (sk_pad + 127) / 128;
  pr.BN = BN;
  pr.n_qt = (sq + kQTile - 1) / kQTile;
  pr.tiles_per_split = tiles_per_split;
  pr.n_split = n_split;
  pr.n_items = pr.n_kb * BN * n_split;
  pr.dk = (float*)dk;
  pr.dv = (float*)dv;
  pr.part = (float*)part;
  fa_f32_dkv_tc_kernel<<<pr.n_items < sms ? pr.n_items : sms, kThreads, DkvSmem::kBytes,
                         (cudaStream_t)stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], pr);
  return (int)cudaGetLastError();
}

// dk, dv (n floats each) = the n_split partials of part summed in order
extern "C" int fg_flash_bwd_dkv_reduce_f32(const void* part, void* dk, void* dv, int n_split,
                                           int n, void* stream) {
  const int n4 = n / 4;
  fa_f32_dkv_reduce_kernel<<<(2 * n4 + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)part, (float4*)dk, (float4*)dv, n_split, n4);
  return (int)cudaGetLastError();
}

// dynamic shared memory of K6b (which = 0) or K6c (1), in bytes (printed by
// chip_smoke.py)
extern "C" int fg_flash_f32_tc_smem_bytes(int which) {
  return which == 0 ? DqSmem::kBytes : DkvSmem::kBytes;
}
