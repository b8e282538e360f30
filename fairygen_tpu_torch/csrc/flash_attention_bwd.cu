// K6b and K6c: the two backward kernels of flash attention with a gradient
// on head-major bf16 q/k/v/dO (B*N, S_pad, D), for Hopper (sm_90a): D = 128
// on the LoRA training path of the Wan DiT, D = 64 on the bf16 SDXL UNet's
// (BrushNet training, SDXL distillation).  One template serves both head
// dims: a 128-row tile of D bf16 is D / 64 boxes of 64 columns.
//
// Replaces the TPU kernels fairygen_tpu/ops/flash_attention.py:
//   K6b _fa_bwd_dq_kernel  (:295)  dQ = f * sum_j [P o (dP - delta)] K_j
//   K6c _fa_bwd_dkv_kernel (:329)  dV = sum_i P^T dO_i,
//                                  dK = sum_i [P o (dP - delta)]^T Q_i / log2(e)
// Contract (the JAX package's): q carries hd^-1/2 * log2(e), so P =
// exp2(s - lse), where lse = m + log2(l) is the forward's (K6a) per-row
// base-2 logsumexp, one fp32 value per row; delta = sum_d dO * O is one fp32
// value per row, computed by the caller; dP = dO V^T.  P and dS = P o (dP -
// delta) are rounded to bf16 before each product, sums run in fp32, and
// each output is rounded once to bf16.  K6b: key columns >= sk_actual give
// P = 0 exactly; every row below Sq_pad is written.  K6c: queries >= sq add
// nothing, whatever the padded rows of lse and delta hold; key rows >=
// sk_actual come out exactly 0; every row below Sk_pad is written.  Neither
// kernel uses atomics: K6b owns q rows and K6c key rows, as the TPU kernels
// split the work, so each output element is written by one CTA and the
// same inputs give the same bits on every run.
//
// Bound on the H100: operations.  6 (K6b: S, dP, dQ) and 8 (K6c: S, dP,
// dV, dK) x BN Sq Sk D flops against a few bytes a row: 1.250 and 1.667
// ms at the training path's 24 x 8190 x 8190 x 128 (989 TFLOP/s bf16).  At
// D = 64 the products halve but each kernel still recomputes P = exp2(S -
// lse), one exp2 a score (at 10 x 4096^2, 1.7e8 exp2 at 16 a clock on 132
// SMs: 0.040-0.045 ms beside 0.065 / 0.087 ms of products); at the SDXL
// cross-attention's 77 keys the bytes of q, dO, dQ bound them.  Design
// (K3's in csrc/flash_attention.cu):
//   - persistent: one CTA of 384 threads on each SM walks the items
//     blockIdx.x, blockIdx.x + gridDim.x, ...; warpgroup 0 is the producer
//     (after setmaxnreg.dec one thread issues every TMA load, through 3-D
//     maps (128, S_pad, BN) of 64-column boxes with the 128-byte swizzle; a
//     box past a head's rows reads zeros, so a 128-row tile needs no
//     padding at S_pad % 128 == 64); warpgroups 1 and 2 are the consumers
//     (setmaxnreg.inc to 240 registers), each owning 64 rows of the item;
//   - at D = 64 every tile is one 64-column box, the products take half
//     the k-steps (S, dP) or the m64n64k16 form (dQ, dK, dV), and the
//     accumulators half the registers; K6b's K / V ring is 4 stages deep
//     in place of 2; nothing else changes;
//   - every operand is loaded once into a swizzled tile and read K-major by
//     one product and MN-major by another: nothing is transposed or copied
//     twice;
//   - K6b: an item is 128 q rows of one head, the q block innermost, so the
//     CTAs that run together share a head's K and V in L2.  Q, dO, lse and
//     delta are loaded once an item; K and V stream in 128-key tiles
//     through a 2-stage ring at D = 128, 4 at D = 64 (K and V apart, so S
//     starts before V lands).
//     Per tile, each consumer: S = Q K^T and dP = dO V^T (wgmma
//     m64n128k16, both operands K-major), P = exp2(S - lse) while dP is
//     still on the tensor cores, dS = P o (dP - delta) (key columns >=
//     sk_actual selected to 0, in the ragged form only), then dS as the
//     register A operand of dQ += dS K with K MN-major (the tile S read
//     K-major).  S, dP and dQ take 192 registers a thread (160 at D =
//     64).  Only
//     ceil(sk_actual / 128) key tiles are computed: the tiles past them
//     add exact zeros.  dQ f is rounded once to bf16 and stored from
//     registers, rows < Sq_pad;
//   - K6c: an item is 128 keys of one head, the key block innermost, so the
//     CTAs that run together share a head's Q and dO in L2.  K and V are
//     loaded once an item and stay; Q, dO and the tile's lse and delta (64
//     fp32 each, by TMA without swizzle) stream in 64-query tiles through a
//     4-stage ring.  Per tile, each consumer (64 keys): S^T = K Q^T and
//     dP^T = V dO^T (wgmma m64n64k16, both operands K-major), P^T =
//     exp2(S^T - lse) and dS^T = P^T o (dP^T - delta) in registers, then
//     dV += P^T dO and dK += dS^T Q (register A, m64n128k16, dO and Q
//     MN-major: the tiles S^T and dP^T read K-major).  dK and dV take 128
//     fp32 registers a thread (64 at D = 64), S^T and dP^T 64: at 64
//     queries a tile that fits 240 registers, at 128 it would not.  A query column >= sq takes
//     lse = +inf and delta = 0 (so P = 0 exactly), one select a column and
//     operand (32 a tile and thread), and a key row >= sk_actual is stored
//     as 0, so K6c has one form.  Only ceil(sq / 64) q tiles are computed;
//     an item whose keys all lie at or past sk_actual loads nothing and
//     stores zeros.  24 heads x 512 keys (the text cross-attention) is 96
//     items for 132 SMs; 64-key items would make 192, two rounds of half
//     the work, the same critical path, so one item size serves both
//     shapes.  SDXL's cross-attention (77 keys: one item a head, 10 or 20
//     items) leaves most SMs idle, each item walking all its queries; it
//     stays so for now, correct and without atomics (the fp32 K6c splits
//     its query loop and sums the splits in order,
//     csrc/flash_attention_fp32_bwd.cu);
//   - the two consumer warpgroups are independent, so one's exp2 runs under
//     the other's wgmma; inside a consumer each tile's products are waited
//     for before the next tile's are issued;
//   - no branch and no loop the compiler can see sits between a wgmma's
//     issue and its wait (mbarrier waits loop inside their asm, arrivals
//     are predicated), else ptxas serializes the wgmmas.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384;          // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBox128 = 128 * 128;     // bytes of a 64-column box of 128 rows
constexpr int kBox64 = 64 * 128;       // bytes of a 64-column box of 64 rows
template <int D>  // a 128 x D bf16 tile
__host__ __device__ constexpr int tile128() { return (D / 64) * kBox128; }
template <int D>  // a 64 x D bf16 tile
__host__ __device__ constexpr int tile64() { return (D / 64) * kBox64; }
constexpr float kInvLog2e = 0.6931471805599453f;

struct Params {
  int sq;  // K6c: queries >= sq add nothing
  int sq_pad, sk_actual, sk_pad;
  int n_blocks;  // items a head: 128-row q blocks (K6b), 128-key blocks (K6c)
  int n_items;   // n_blocks * BN
  int n_tiles;   // tiles an item loops over: 128 keys (K6b), 64 queries (K6c)
  float dq_factor;
  void* out0;    // dq (K6b), dk (K6c)
  void* out1;    // dv (K6c)
};

// one work item: 128 rows from r0 of head bn, the block innermost
struct Item {
  int r0, bn;
};

__device__ __forceinline__ Item item_of(int w, int n_blocks) {
  Item it;
  it.r0 = (w % n_blocks) * 128;
  it.bn = w / n_blocks;
  return it;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// rows `row` and row + 8 of a head's (rows, D) bf16 output (from element
// row0 * D) = a 64 x D accumulator (wgmma layout) x scale, rounded once;
// rows >= `rows` are not stored, rows >= `keep` are stored as 0
template <int D>
__device__ __forceinline__ void store_rows(void* out, const float* acc, float scale,
                                           size_t row0, int row, int rows, int keep, int tg) {
  // column 8j + 2tg of a row is its bf16 pair 4j + tg
  uint32_t* dst = reinterpret_cast<uint32_t*>(out) + (row0 + row) * (D / 2) + tg;
  if (row < rows) {
    const bool ok = row < keep;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dst[4 * j] = ok ? pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale) : 0u;
  }
  if (row + 8 < rows) {
    const bool ok = row + 8 < keep;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dst[8 * (D / 2) + 4 * j] =
          ok ? pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale) : 0u;
  }
}

// ---------------------------------------------------------------- K6b

template <int D>
struct DqSmem {
  static constexpr int kTile = tile128<D>();
  static constexpr int kStages = D == 64 ? 4 : 2;   // K and V ring depth
  static constexpr int kQ = 0;                      // Q, 128 x D
  static constexpr int kDO = kTile;                 // dO, 128 x D
  static constexpr int kK = 2 * kTile;              // the K ring
  static constexpr int kV = kK + kStages * kTile;   // the V ring
  static constexpr int kLse = kV + kStages * kTile; // 128 fp32
  static constexpr int kDelta = kLse + 128 * 4;     // 128 fp32
  static constexpr int kBar = kDelta + 128 * 4;
  static constexpr int kBytes = kBar + (2 + 4 * kStages) * 8 + 1024;  // + 1024-alignment slack
};

template <int D, bool kRagged>
__device__ __forceinline__ void bwd_dq(const CUtensorMap* tq, const CUtensorMap* tk,
                                       const CUtensorMap* tv, const CUtensorMap* tdo,
                                       const CUtensorMap* tlse, const CUtensorMap* tdelta,
                                       const Params& pr) {
  using L = DqSmem<D>;
  constexpr int kStages = L::kStages;
  constexpr int kTile = L::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* qd_full = bars;  // Q, dO, lse and delta of an item
  uint64_t* qd_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // this CTA's items: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int mine = (pr.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_kt = pr.n_tiles;
  const int wg = threadIdx.x / 128;
  auto item = [&](int i) { return item_of(blockIdx.x + i * gridDim.x, pr.n_blocks); };

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    mbar_init(qd_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(tq);
      prefetch_map(tk);
      prefetch_map(tv);
      prefetch_map(tdo);
      prefetch_map(tlse);
      prefetch_map(tdelta);
      int t = 0;
      for (int i = 0; i < mine; ++i) {
        const Item it = item(i);
        // item i's rows once both consumers' last S and dP of item i - 1 are in
        mbar_wait(qd_empty, (i & 1) ^ 1);
        mbar_arrive_expect_tx(qd_full, 2 * kTile + 2 * 128 * 4);
        for (int h = 0; h < D / 64; ++h) {
          tma_load_3d(smem + L::kQ + h * kBox128, tq, qd_full, 64 * h, it.r0, it.bn);
          tma_load_3d(smem + L::kDO + h * kBox128, tdo, qd_full, 64 * h, it.r0, it.bn);
        }
        tma_load_2d(smem + L::kLse, tlse, qd_full, it.r0, it.bn);
        tma_load_2d(smem + L::kDelta, tdelta, qd_full, it.r0, it.bn);
        for (int j = 0; j < n_kt; ++j, ++t) {
          const int s = t % kStages;
          const uint32_t ph = (t / kStages) & 1;
          uint8_t* kt = smem + L::kK + s * kTile;
          uint8_t* vt = smem + L::kV + s * kTile;
          mbar_wait(&k_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&k_full[s], kTile);
          for (int h = 0; h < D / 64; ++h)
            tma_load_3d(kt + h * kBox128, tk, &k_full[s], 64 * h, j * 128, it.bn);
          mbar_wait(&v_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&v_full[s], kTile);
          for (int h = 0; h < D / 64; ++h)
            tma_load_3d(vt + h * kBox128, tv, &v_full[s], 64 * h, j * 128, it.bn);
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
    const uint32_t q_rows = base + L::kQ + cw * 64 * 128;  // this warpgroup's rows
    const uint32_t do_rows = base + L::kDO + cw * 64 * 128;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
    const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta);
    float dq[D / 2], s[64], dp[64];
    uint32_t a[32];
    int t = 0;
    for (int i = 0; i < mine; ++i) {
      const Item it = item(i);
      mbar_wait(qd_full, i & 1);
      const float lse0 = lse_s[qr], lse1 = lse_s[qr + 8];
      const float dl0 = delta_s[qr], dl1 = delta_s[qr + 8];
#pragma unroll
      for (int k = 0; k < D / 2; ++k) dq[k] = 0.f;
      for (int j = 0; j < n_kt; ++j, ++t) {
        const int st = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        const uint32_t kt = base + L::kK + st * kTile;
        mbar_wait(&k_full[st], ph);
        wgmma_fence();
        tile_scores<D>(s, q_rows, kt);
        wgmma_commit();
        mbar_wait(&v_full[st], ph);
        tile_scores<D>(dp, do_rows, base + L::kV + st * kTile);
        wgmma_commit();
        wgmma_wait<1>();  // S is in; dP still runs
        fence_regs<64>(s);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          s[4 * jj] = ex2(s[4 * jj] - lse0);
          s[4 * jj + 1] = ex2(s[4 * jj + 1] - lse0);
          s[4 * jj + 2] = ex2(s[4 * jj + 2] - lse1);
          s[4 * jj + 3] = ex2(s[4 * jj + 3] - lse1);
        }
        wgmma_wait<0>();
        fence_regs<64>(dp);
        mbar_arrive_if(&v_empty[st], lane == 0);
        mbar_arrive_if(qd_empty, lane == 0 && j == n_kt - 1);
        // dS = P o (dP - delta); the ragged form selects 0 at key columns
        // >= sk_actual (lim >= 128 before the last tile)
        const int lim = pr.sk_actual - j * 128 - 2 * tg;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x0 = s[4 * jj + e] * (dp[4 * jj + e] - dl0);
            const float x1 = s[4 * jj + 2 + e] * (dp[4 * jj + 2 + e] - dl1);
            const bool out = kRagged && 8 * jj + e >= lim;
            s[4 * jj + e] = out ? 0.f : x0;
            s[4 * jj + 2 + e] = out ? 0.f : x1;
          }
        to_a_fragments(s, a);
        fence_regs<32>(a);
        fence_regs<D / 2>(dq);
        wgmma_fence();
        tile_pv<D>(dq, a, kt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(dq);
        mbar_arrive_if(&k_empty[st], lane == 0);
      }
      store_rows<D>(pr.out0, dq, pr.dq_factor, (size_t)it.bn * pr.sq_pad, it.r0 + qr, pr.sq_pad,
                 pr.sq_pad, tg);
    }
  }
}

// ---------------------------------------------------------------- K6c

template <int D>
struct DkvSmem {
  static constexpr int kStages = 4;                        // Q / dO / lse / delta ring depth
  static constexpr int kK = 0;                             // K, 128 keys x D
  static constexpr int kV = tile128<D>();                  // V, 128 keys x D
  static constexpr int kQ = 2 * tile128<D>();              // the Q ring, 64 x D a stage
  static constexpr int kDO = kQ + kStages * tile64<D>();   // the dO ring
  static constexpr int kLse = kDO + kStages * tile64<D>(); // 64 fp32 a stage
  static constexpr int kDelta = kLse + kStages * 64 * 4; // 64 fp32 a stage
  static constexpr int kBar = kDelta + kStages * 64 * 4;
  static constexpr int kBytes = kBar + (2 + 2 * kStages) * 8 + 1024;  // + 1024-alignment slack
};

// S^T (64 keys x 64 queries) = this warpgroup's 64 rows of a 128-row tile
// (x_rows) times a 64-row tile (y_base) transposed: D / 16 k-steps of 16
// along d, four in each 64-column box (32 bytes apart in a 128-byte row)
template <int D>
__device__ __forceinline__ void scores_t(float* s, uint32_t x_rows, uint32_t y_base) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_m64n64k16_ss(s, desc_sw128(x_rows + (ks / 4) * kBox128 + (ks % 4) * 32, 16, 1024),
                       desc_sw128(y_base + (ks / 4) * kBox64 + (ks % 4) * 32, 16, 1024), ks > 0);
}

// acc (64 x D) += A (64 x 64 queries, bf16 in registers) · Y (64 queries x
// D), Y MN-major: the 16 queries of k-step ks are 16 rows (2048 bytes) on,
// its 64-column boxes kBox64 apart; m64n128k16 at D = 128, m64n64k16 at 64
template <int D>
__device__ __forceinline__ void accumulate_t(float* acc, const uint32_t* a, uint32_t y_base) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t desc = desc_sw128(y_base + ks * 2048, kBox64, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs_tb(acc, a + 4 * ks, desc);
    else
      wgmma_m64n64k16_rs_tb(acc, a + 4 * ks, desc);
  }
}

template <int D>
__device__ __forceinline__ void bwd_dkv(const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const CUtensorMap* tdo,
                                        const CUtensorMap* tlse, const CUtensorMap* tdelta,
                                        const Params& pr) {
  using L = DkvSmem<D>;
  constexpr int kStages = L::kStages;
  constexpr int kTile = tile128<D>(), kQTile = tile64<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bars;  // K and V of an item
  uint64_t* kv_empty = bars + 1;
  uint64_t* q_full = bars + 2;  // a stage of the Q / dO / lse / delta ring
  uint64_t* q_empty = q_full + kStages;

  const int mine = (pr.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_qt = pr.n_tiles;
  const int wg = threadIdx.x / 128;
  auto item = [&](int i) { return item_of(blockIdx.x + i * gridDim.x, pr.n_blocks); };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load; an item whose keys all
    // lie at or past sk_actual loads nothing
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(tq);
      prefetch_map(tk);
      prefetch_map(tv);
      prefetch_map(tdo);
      prefetch_map(tlse);
      prefetch_map(tdelta);
      int t = 0, c = 0;
      for (int i = 0; i < mine; ++i) {
        const Item it = item(i);
        if (it.r0 >= pr.sk_actual) continue;
        // K and V once both consumers are done with the last item's
        mbar_wait(kv_empty, (c & 1) ^ 1);
        ++c;
        mbar_arrive_expect_tx(kv_full, 2 * kTile);
        for (int h = 0; h < D / 64; ++h) {
          tma_load_3d(smem + L::kK + h * kBox128, tk, kv_full, 64 * h, it.r0, it.bn);
          tma_load_3d(smem + L::kV + h * kBox128, tv, kv_full, 64 * h, it.r0, it.bn);
        }
        for (int j = 0; j < n_qt; ++j, ++t) {
          const int s = t % kStages;
          const uint32_t ph = (t / kStages) & 1;
          mbar_wait(&q_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&q_full[s], 2 * kQTile + 2 * 64 * 4);
          for (int h = 0; h < D / 64; ++h) {
            tma_load_3d(smem + L::kQ + s * kQTile + h * kBox64, tq, &q_full[s], 64 * h, j * 64,
                        it.bn);
            tma_load_3d(smem + L::kDO + s * kQTile + h * kBox64, tdo, &q_full[s], 64 * h,
                        j * 64, it.bn);
          }
          tma_load_2d(smem + L::kLse + s * 256, tlse, &q_full[s], j * 64, it.bn);
          tma_load_2d(smem + L::kDelta + s * 256, tdelta, &q_full[s], j * 64, it.bn);
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
    const uint32_t k_rows = base + L::kK + cw * 64 * 128;  // this warpgroup's keys
    const uint32_t v_rows = base + L::kV + cw * 64 * 128;
    float dk[D / 2], dv[D / 2], st[32], dpt[32];
    uint32_t pa[16], da[16];
    int t = 0, c = 0;
    for (int i = 0; i < mine; ++i) {
      const Item it = item(i);
#pragma unroll
      for (int k = 0; k < D / 2; ++k) {
        dk[k] = 0.f;
        dv[k] = 0.f;
      }
      if (it.r0 < pr.sk_actual) {
        mbar_wait(kv_full, c & 1);
        ++c;
        for (int j = 0; j < n_qt; ++j, ++t) {
          const int s = t % kStages;
          const uint32_t ph = (t / kStages) & 1;
          const uint32_t qt = base + L::kQ + s * kQTile, dt = base + L::kDO + s * kQTile;
          const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse + s * 256);
          const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta + s * 256);
          mbar_wait(&q_full[s], ph);
          wgmma_fence();
          scores_t<D>(st, k_rows, qt);
          wgmma_commit();
          scores_t<D>(dpt, v_rows, dt);
          wgmma_commit();
          // query column 8jj + 2tg + e of the tile is real while 8jj + e < lim
          const int lim = pr.sq - j * 64 - 2 * tg;
          wgmma_wait<1>();  // S^T is in; dP^T still runs
          fence_regs<32>(st);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * jj + 2 * tg);
            const float l0 = 8 * jj < lim ? l.x : INFINITY;
            const float l1 = 8 * jj + 1 < lim ? l.y : INFINITY;
            st[4 * jj] = ex2(st[4 * jj] - l0);
            st[4 * jj + 1] = ex2(st[4 * jj + 1] - l1);
            st[4 * jj + 2] = ex2(st[4 * jj + 2] - l0);
            st[4 * jj + 3] = ex2(st[4 * jj + 3] - l1);
          }
          wgmma_wait<0>();
          fence_regs<32>(dpt);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * jj + 2 * tg);
            const float d0 = 8 * jj < lim ? dl.x : 0.f;
            const float d1 = 8 * jj + 1 < lim ? dl.y : 0.f;
            dpt[4 * jj] = st[4 * jj] * (dpt[4 * jj] - d0);
            dpt[4 * jj + 1] = st[4 * jj + 1] * (dpt[4 * jj + 1] - d1);
            dpt[4 * jj + 2] = st[4 * jj + 2] * (dpt[4 * jj + 2] - d0);
            dpt[4 * jj + 3] = st[4 * jj + 3] * (dpt[4 * jj + 3] - d1);
          }
          to_a_fragments<4>(st, pa);
          to_a_fragments<4>(dpt, da);
          fence_regs<16>(pa);
          fence_regs<16>(da);
          fence_regs<D / 2>(dv);
          fence_regs<D / 2>(dk);
          wgmma_fence();
          accumulate_t<D>(dv, pa, dt);
          accumulate_t<D>(dk, da, qt);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<D / 2>(dv);
          fence_regs<D / 2>(dk);
          mbar_arrive_if(&q_empty[s], lane == 0);
        }
        mbar_arrive_if(kv_empty, lane == 0);
      }
      const int row = it.r0 + cw * 64 + r;
      const size_t row0 = (size_t)it.bn * pr.sk_pad;
      store_rows<D>(pr.out0, dk, kInvLog2e, row0, row, pr.sk_pad, pr.sk_actual, tg);
      store_rows<D>(pr.out1, dv, 1.f, row0, row, pr.sk_pad, pr.sk_actual, tg);
    }
  }
}

#define FG_BWD_KERNEL(name, ...)                                                             \
  __global__ void __launch_bounds__(kThreads, 1)                                            \
      name(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,   \
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,  \
           const __grid_constant__ CUtensorMap tlse,                                         \
           const __grid_constant__ CUtensorMap tdelta, const Params pr) {                    \
    __VA_ARGS__(&tq, &tk, &tv, &tdo, &tlse, &tdelta, pr);                                    \
  }

// K6b at head dim 128, sk_actual a multiple of 128: no mask
FG_BWD_KERNEL(fa_dq_wgmma_kernel, bwd_dq<128, false>)
// K6b at head dim 128, key columns >= sk_actual selected to 0 in dS
FG_BWD_KERNEL(fa_dq_wgmma_ragged_kernel, bwd_dq<128, true>)
// K6c at head dim 128, any lengths
FG_BWD_KERNEL(fa_dkv_wgmma_kernel, bwd_dkv<128>)
// K6b at head dim 64 (the bf16 SDXL UNet), aligned and ragged
FG_BWD_KERNEL(fa_dq_d64_wgmma_kernel, bwd_dq<64, false>)
FG_BWD_KERNEL(fa_dq_d64_wgmma_ragged_kernel, bwd_dq<64, true>)
// K6c at head dim 64, any lengths
FG_BWD_KERNEL(fa_dkv_d64_wgmma_kernel, bwd_dkv<64>)
#undef FG_BWD_KERNEL

typedef void (*BwdKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const CUtensorMap, const CUtensorMap, const Params);

// the kernel's shared-memory limit, set once per kernel (a static in each
// entry); 0 or a cudaError_t value
int allow_smem(BwdKernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the six maps and the launch: q and dO (BN, sq_pad, D) and k and v (BN,
// sk_pad, D) in boxes of 64 columns by q_box / 128 rows; lse and delta
// (BN, sq_pad) fp32 in boxes of q_box, unswizzled
template <int D>
int launch(BwdKernel kernel, int smem_rc, int smem_bytes, int q_box, const void* qh,
           const void* kh, const void* vh, const void* doh, const void* lse,
           const void* delta, int BN, const Params& pr, void* stream) {
  if (smem_rc) return smem_rc;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const cuuint32_t qbox[3] = {64, (cuuint32_t)q_box, 1};
  const cuuint64_t qdims[3] = {D, (cuuint64_t)pr.sq_pad, (cuuint64_t)BN};
  const cuuint64_t qstrides[2] = {D * 2, (cuuint64_t)pr.sq_pad * D * 2};
  int rc = make_map_bf16(&tq, qh, 3, qdims, qstrides, qbox);
  if (rc || (rc = make_map_bf16(&tdo, doh, 3, qdims, qstrides, qbox))) return rc;
  const cuuint32_t kbox[3] = {64, 128, 1};
  const cuuint64_t kdims[3] = {D, (cuuint64_t)pr.sk_pad, (cuuint64_t)BN};
  const cuuint64_t kstrides[2] = {D * 2, (cuuint64_t)pr.sk_pad * D * 2};
  if ((rc = make_map_bf16(&tk, kh, 3, kdims, kstrides, kbox))) return rc;
  if ((rc = make_map_bf16(&tv, vh, 3, kdims, kstrides, kbox))) return rc;
  const cuuint32_t rbox[2] = {(cuuint32_t)q_box, 1};
  const cuuint64_t rdims[2] = {(cuuint64_t)pr.sq_pad, (cuuint64_t)BN};
  const cuuint64_t rstrides[1] = {(cuuint64_t)pr.sq_pad * 4};
  if ((rc = make_map(&tlse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, 2, rdims, rstrides, rbox,
                     CU_TENSOR_MAP_SWIZZLE_NONE)))
    return rc;
  if ((rc = make_map(&tdelta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, delta, 2, rdims, rstrides, rbox,
                     CU_TENSOR_MAP_SWIZZLE_NONE)))
    return rc;
  kernel<<<pr.n_items < sms ? pr.n_items : sms, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, pr);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes (checked by the Python wrappers), head dim d = 64 or 128: qh,
// doh, dq (BN, sq_pad, d) bf16; kh, vh, dk, dv (BN, sk_pad, d) bf16; lse,
// delta (BN, sq_pad) fp32; sq_pad and sk_pad multiples of 64; 1 <=
// sk_actual <= sk_pad and 1 <= sq <= sq_pad; every pointer 16-byte aligned.
extern "C" int fg_flash_bwd_dq(const void* qh, const void* kh, const void* vh, const void* doh,
                               const void* lse, const void* delta, void* dq, float dq_factor,
                               int BN, int sq_pad, int sk_actual, int sk_pad, int d,
                               void* stream) {
  static int rc_even = allow_smem(fa_dq_wgmma_kernel, DqSmem<128>::kBytes);
  static int rc_ragged = allow_smem(fa_dq_wgmma_ragged_kernel, DqSmem<128>::kBytes);
  static int rc64_even = allow_smem(fa_dq_d64_wgmma_kernel, DqSmem<64>::kBytes);
  static int rc64_ragged = allow_smem(fa_dq_d64_wgmma_ragged_kernel, DqSmem<64>::kBytes);
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  Params pr = {};
  pr.sq_pad = sq_pad;
  pr.sk_actual = sk_actual;
  pr.sk_pad = sk_pad;
  pr.n_blocks = (sq_pad + 127) / 128;
  pr.n_items = pr.n_blocks * BN;
  pr.n_tiles = (sk_actual + 127) / 128;
  pr.dq_factor = dq_factor;
  pr.out0 = dq;
  const bool ragged = sk_actual % 128 != 0;
  if (d == 64)
    return launch<64>(ragged ? fa_dq_d64_wgmma_ragged_kernel : fa_dq_d64_wgmma_kernel,
                      ragged ? rc64_ragged : rc64_even, DqSmem<64>::kBytes, 128, qh, kh, vh, doh,
                      lse, delta, BN, pr, stream);
  return launch<128>(ragged ? fa_dq_wgmma_ragged_kernel : fa_dq_wgmma_kernel,
                     ragged ? rc_ragged : rc_even, DqSmem<128>::kBytes, 128, qh, kh, vh, doh, lse,
                     delta, BN, pr, stream);
}

extern "C" int fg_flash_bwd_dkv(const void* qh, const void* kh, const void* vh, const void* doh,
                                const void* lse, const void* delta, void* dk, void* dv, int BN,
                                int sq, int sq_pad, int sk_actual, int sk_pad, int d,
                                void* stream) {
  static int rc = allow_smem(fa_dkv_wgmma_kernel, DkvSmem<128>::kBytes);
  static int rc64 = allow_smem(fa_dkv_d64_wgmma_kernel, DkvSmem<64>::kBytes);
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  Params pr = {};
  pr.sq = sq;
  pr.sq_pad = sq_pad;
  pr.sk_actual = sk_actual;
  pr.sk_pad = sk_pad;
  pr.n_blocks = (sk_pad + 127) / 128;
  pr.n_items = pr.n_blocks * BN;
  pr.n_tiles = (sq + 63) / 64;
  pr.out0 = dk;
  pr.out1 = dv;
  if (d == 64)
    return launch<64>(fa_dkv_d64_wgmma_kernel, rc64, DkvSmem<64>::kBytes, 64, qh, kh, vh, doh,
                      lse, delta, BN, pr, stream);
  return launch<128>(fa_dkv_wgmma_kernel, rc, DkvSmem<128>::kBytes, 64, qh, kh, vh, doh, lse,
                     delta, BN, pr, stream);
}

// dynamic shared memory of K6b (which = 0) and K6c (1) at head dim 128,
// and of K6b (2) and K6c (3) at head dim 64, in bytes (printed by
// chip_smoke.py)
extern "C" int fg_flash_bwd_smem_bytes(int which) {
  switch (which) {
    case 0: return DqSmem<128>::kBytes;
    case 1: return DkvSmem<128>::kBytes;
    case 2: return DqSmem<64>::kBytes;
    default: return DkvSmem<64>::kBytes;
  }
}
