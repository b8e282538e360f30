// K3 and K4: max-free ("bounded logits") attention on head-major q/k,
// writing the natural (B, S, N*128) layout, for Hopper (sm_90a).
//
// Replaces the TPU kernels fairygen_tpu/ops/flash_attention.py:
//   K3 _fa_kernel_bounded   (several k tiles; entry flash_attention_heads_major)
//   K4 _fa_small_kv_kernel  (one TPU k tile, bounded form with pad_correct)
// Contract (shared with ops/fused_qk): q is prescaled by hd^-1/2 * log2(e)
// and both q and k are rms-normed, so |logit| < 17 and softmax ==
// exp2(s) / sum(exp2(s)) with no running max.  Every key row at or past Lv
// (v_rows) is zero, so the key loop stops at Lv rounded up to the 128-key
// tile; each zero key row it computes adds exactly exp2(0) = 1 to the row
// sum and nothing to the output, so l -= (keys looped - sk_actual) replaces
// any mask (zero gap rows inside [0, Lv), FLUX.1's joint layout, are looped
// and counted the same way).  v is read in its natural (B, Lv, N, 128)
// layout; q rows >= sq are computed only as part of a 128-row tile and are
// never stored.
//
// Bound on the H100: operations (4 * Sq * Sk * 128 flops a head, far above
// the ridge).  A work item is 128 q rows of one (b, n).  Design:
//   - persistent: one CTA of 384 threads on each SM walks the items
//     blockIdx.x, blockIdx.x + gridDim.x, ...; consecutive CTAs hold
//     neighbouring q tiles of one head, whose K and V then stay in L2;
//   - warpgroup 0 is the producer: after setmaxnreg.dec one thread issues
//     every TMA load; warpgroups 1 and 2 (setmaxnreg.inc to 232 registers)
//     each own 64 rows of the item;
//   - Q (128 x 128) arrives by TMA into one of two buffers, the A operand of
//     S = Q K^T, the next item's right after the current item's first K/V
//     tile; K and V stream in 128-key tiles through a ring of kStages stages
//     with a full and an empty mbarrier each (K and V apart, so S can start
//     before V lands); the 3-D maps (128, S_pad, B*N) for q/k and the 4-D
//     map (128, N, Lv, B) for v zero-fill inside their own head and batch;
//   - every tile is 128-byte swizzled: a 128-wide row comes as two 64-column
//     boxes, and wgmma reads the swizzled tile through its descriptor;
//   - S = Q K^T is wgmma.m64n128k16 with both operands K-major in shared
//     memory; p = exp2(s) in registers, l summed in fp32 from the unrounded
//     p, and the S accumulator becomes the bf16 register A fragment of
//     O += P V, a wgmma with V MN-major (its natural rows; the transposed-B
//     form), so nothing is transposed by hand;
//   - overlap inside each consumer warpgroup: tile t's S product and tile
//     t-1's P V product are issued together, and exp2 of tile t runs while
//     the P V product is still on the tensor cores (one S, one P and one O
//     in registers: 160 of them); the loop runs over all of a CTA's tiles,
//     items in a row, so an item's first S product overlaps the last P V of
//     the item before; the two consumer warpgroups interleave besides;
//   - between two items each consumer writes its 64 finished rows,
//     O / (l - pad) (the fp32 quotient correctly rounded, from one
//     reciprocal a row and an fma correction an element) rounded once to
//     bf16, into a swizzled staging tile that two TMA stores copy out
//     asynchronously (clipping rows >= sq);
//   - only real work: ceil(sq / 128) q tiles and ceil(Lv / 128) key tiles,
//     so padding past them is neither loaded nor computed;
//   - no branch and no loop the compiler can see sits between a wgmma's
//     issue and its wait (mbarrier waits loop inside their asm, arrivals are
//     predicated), else ptxas serializes the wgmmas.
// K4's bounded form is the same kernel over a short key range.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kD = 128;
constexpr int kBM = 128;                 // q rows per CTA (two warpgroups of 64)
constexpr int kBN = 128;                 // keys per tile
constexpr int kStages = 2;               // K and V ring depth
constexpr int kThreads = 384;            // producer warpgroup + two consumer warpgroups
constexpr int kHalf = 128 * 128;         // bytes of one 64-column half of a 128-row tile
constexpr int kTileBytes = 2 * kHalf;    // a 128 x 128 bf16 tile, 32 KB
constexpr int kQOff = 0;                 // two Q buffers: the next item's Q loads early
constexpr int kKOff = 2 * kTileBytes;
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kOOff = kVOff + kStages * kTileBytes;  // each consumer's 64 x 128 output tile
constexpr int kBarOff = kOOff + kTileBytes;
constexpr int kNumBars = 4 + 4 * kStages;
constexpr int kSmemBytes = kBarOff + kNumBars * 8 + 1024;  // + slack for the 1024 alignment
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// p = exp2(s) in place; the unrounded p summed into the two rows' partials
__device__ __forceinline__ void exp2_rows(float* s, float& l0, float& l1) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[4 * j + i] = ex2(s[4 * j + i]);
    l0 += s[4 * j] + s[4 * j + 1];
    l1 += s[4 * j + 2] + s[4 * j + 3];
  }
}

// one work item: 128 q rows (q tile qt) of head bn = b * N + n
struct Item {
  int q0, bn, b, n;
};

__device__ __forceinline__ Item item_of(int w, int n_qt, int N) {
  Item it;
  it.q0 = (w % n_qt) * kBM;
  it.bn = w / n_qt;
  it.b = it.bn / N;
  it.n = it.bn % N;
  return it;
}

// the warpgroup's 64 output rows = O / (l - pad), rounded once to bf16,
// through its 128-byte-swizzled staging tile (two 64-column halves of 64
// rows) and two TMA stores; the store clips rows >= sq.  r = warp * 16 + g.
__device__ __forceinline__ void store_rows(const CUtensorMap* to, uint8_t* stage, const float* o,
                                           float l0, float l1, float pad, const Item& it,
                                           int cw, int tid, int r, int tg) {
  // the four threads of a quad hold disjoint columns of the same two rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 - pad, d1 = l1 - pad;
  const float inv0 = __frcp_rn(d0), inv1 = __frcp_rn(d1);
  if (tid == 0) bulk_wait_read();  // the previous item's stores have read the tile
  named_bar_sync(1 + cw, 128);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    // column 8j + 2tg: half j / 8, 16-byte chunk j % 8 of a 128-byte row,
    // swizzled by the row's position in its 8-row group
    uint8_t* h = stage + (j / 8) * (64 * 128) + tg * 4;
    *reinterpret_cast<uint32_t*>(h + r * 128 + (((j % 8) ^ (r % 8)) << 4)) =
        pack_bf16(div_rn(o[4 * j], d0, inv0), div_rn(o[4 * j + 1], d0, inv0));
    *reinterpret_cast<uint32_t*>(h + (r + 8) * 128 + (((j % 8) ^ (r % 8)) << 4)) =
        pack_bf16(div_rn(o[4 * j + 2], d1, inv1), div_rn(o[4 * j + 3], d1, inv1));
  }
  fence_proxy_async_smem();
  named_bar_sync(1 + cw, 128);
  if (tid == 0) {
    tma_store_4d(to, stage, 0, it.n, it.q0 + cw * 64, it.b);
    tma_store_4d(to, stage + 64 * 128, 64, it.n, it.q0 + cw * 64, it.b);
    bulk_commit();
  }
}

__device__ __forceinline__ void attend(const CUtensorMap* tq, const CUtensorMap* tk,
                                       const CUtensorMap* tv, const CUtensorMap* to, int N,
                                       int n_qt, int n_items, int n_kt, float pad) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* q_full = bars;
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // this CTA's items: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int mine = (n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // one arrival per consumer warp
    }
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
      // Q of item i + 1 goes out right after item i's first K/V tile: its
      // buffer was item i - 1's, free once that item's last S product is in
      auto load_q = [&](int i) {
        const Item it = item_of(blockIdx.x + i * gridDim.x, n_qt, N);
        const int qb = i & 1;
        uint8_t* q = smem + kQOff + qb * kTileBytes;
        mbar_wait(&q_empty[qb], ((i >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], kTileBytes);
        tma_load_3d(q, tq, &q_full[qb], 0, it.q0, it.bn);
        tma_load_3d(q + kHalf, tq, &q_full[qb], 64, it.q0, it.bn);
      };
      load_q(0);
      int t = 0;
      for (int i = 0; i < mine; ++i) {
        const Item it = item_of(blockIdx.x + i * gridDim.x, n_qt, N);
        for (int j = 0; j < n_kt; ++j, ++t) {
          const int s = t % kStages;
          const uint32_t ph = (t / kStages) & 1;
          uint8_t* kt = smem + kKOff + s * kTileBytes;
          uint8_t* vt = smem + kVOff + s * kTileBytes;
          mbar_wait(&k_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&k_full[s], kTileBytes);
          tma_load_3d(kt, tk, &k_full[s], 0, j * kBN, it.bn);
          tma_load_3d(kt + kHalf, tk, &k_full[s], 64, j * kBN, it.bn);
          mbar_wait(&v_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&v_full[s], kTileBytes);
          tma_load_4d(vt, tv, &v_full[s], 0, it.n, j * kBN, it.b);
          tma_load_4d(vt + kHalf, tv, &v_full[s], 64, it.n, j * kBN, it.b);
          if (j == 0 && i + 1 < mine) load_q(i + 1);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 the item's rows 0..63, warpgroup 2 64..127.
    // One loop over this CTA's tiles t = (item i, key tile j), all items in a
    // row, so that the first S product of an item overlaps the last P V of
    // the one before; the finished item is stored between the two.
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + (lane >> 2), tg = lane & 3;
    uint8_t* stage = smem + kOOff + cw * (kTileBytes / 2);
    const uint32_t base = smem_u32(smem);
    const uint32_t q_rows = base + kQOff + cw * 64 * 128;  // this warpgroup's rows
    float o[64], sacc[64];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float l0 = 0.f, l1 = 0.f, l0_done = 0.f, l1_done = 0.f;

    mbar_wait(&q_full[0], 0);
    mbar_wait(&k_full[0], 0);
    wgmma_fence();
    tile_scores<kD>(sacc, q_rows, base + kKOff);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(sacc);
    mbar_arrive_if(&k_empty[0], lane == 0);
    mbar_arrive_if(&q_empty[0], lane == 0 && n_kt == 1);
    exp2_rows(sacc, l0, l1);
    to_a_fragments(sacc, p);

    const int total = mine * n_kt;
    int i = 0, j = 0;
    for (int t = 1; t < total; ++t) {
      if (++j == n_kt) {
        j = 0;
        ++i;
      }
      const int s = t % kStages, sp = (t - 1) % kStages;
      const uint32_t ph = (t / kStages) & 1, php = ((t - 1) / kStages) & 1;
      const int qb = i & 1;
      if (j == 0) mbar_wait(&q_full[qb], (i >> 1) & 1);
      mbar_wait(&k_full[s], ph);
      fence_regs<64>(o);
      fence_regs<32>(p);
      wgmma_fence();
      tile_scores<kD>(sacc, q_rows + qb * kTileBytes, base + kKOff + s * kTileBytes);
      wgmma_commit();
      mbar_wait(&v_full[sp], php);
      tile_pv<kD>(o, p, base + kVOff + sp * kTileBytes);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile t is in; P V of tile t-1 still runs
      fence_regs<64>(sacc);
      mbar_arrive_if(&k_empty[s], lane == 0);
      mbar_arrive_if(&q_empty[qb], lane == 0 && j == n_kt - 1);
      // a new item: the sums so far are the finished item's
      l0_done = j == 0 ? l0 : l0_done;
      l1_done = j == 0 ? l1 : l1_done;
      l0 = j == 0 ? 0.f : l0;
      l1 = j == 0 ? 0.f : l1;
      exp2_rows(sacc, l0, l1);
      wgmma_wait<0>();
      fence_regs<64>(o);
      mbar_arrive_if(&v_empty[sp], lane == 0);
      if (j == 0) {
        store_rows(to, stage, o, l0_done, l1_done, pad,
                   item_of(blockIdx.x + (i - 1) * gridDim.x, n_qt, N), cw, tid, r, tg);
#pragma unroll
        for (int k = 0; k < 64; ++k) o[k] = 0.f;
      }
      to_a_fragments(sacc, p);
    }
    const int sl = (total - 1) % kStages;
    mbar_wait(&v_full[sl], ((total - 1) / kStages) & 1);
    fence_regs<64>(o);
    fence_regs<32>(p);
    wgmma_fence();
    tile_pv<kD>(o, p, base + kVOff + sl * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(o);
    store_rows(to, stage, o, l0, l1, pad, item_of(blockIdx.x + (mine - 1) * gridDim.x, n_qt, N),
               cw, tid, r, tg);
    if (tid == 0) bulk_wait();
  }
}

// K3: self-attention over several 128-key tiles
__global__ void __launch_bounds__(kThreads, 1)
fa_bounded_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                  int N, int n_qt, int n_items, int n_kt, float pad) {
  attend(&tq, &tk, &tv, &to, N, n_qt, n_items, n_kt, pad);
}

// K4: the whole key range is one TPU k tile (text cross-attention, Lk = 512;
// Z-Image's 320-token caption refiner)
__global__ void __launch_bounds__(kThreads, 1)
fa_small_kv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   int N, int n_qt, int n_items, int n_kt, float pad) {
  attend(&tq, &tk, &tv, &to, N, n_qt, n_items, n_kt, pad);
}

typedef void (*AttendKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                             const CUtensorMap, int, int, int, int, float);

// the kernel's shared-memory limit, set once per kernel (a static in each
// entry); 0 or a cudaError_t value
int allow_smem(AttendKernel kernel) {
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

int launch(AttendKernel kernel, int smem_rc, const void* qh, const void* kh, const void* v,
           void* out, int B, int N, int sq, int sq_pad, int sk_actual, int sk_pad, int v_rows,
           void* stream) {
  if (smem_rc) return smem_rc;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  CUtensorMap tq, tk, tv, to;
  const cuuint32_t box3[3] = {64, kBM, 1};
  const cuuint64_t qdims[3] = {kD, (cuuint64_t)sq_pad, (cuuint64_t)B * N};
  const cuuint64_t qstrides[2] = {kD * 2, (cuuint64_t)sq_pad * kD * 2};
  int rc = make_map_bf16(&tq, qh, 3, qdims, qstrides, box3);
  if (rc) return rc;
  const cuuint64_t kdims[3] = {kD, (cuuint64_t)sk_pad, (cuuint64_t)B * N};
  const cuuint64_t kstrides[2] = {kD * 2, (cuuint64_t)sk_pad * kD * 2};
  rc = make_map_bf16(&tk, kh, 3, kdims, kstrides, box3);
  if (rc) return rc;
  const cuuint32_t box4[4] = {64, 1, kBN, 1};
  const cuuint64_t vdims[4] = {kD, (cuuint64_t)N, (cuuint64_t)v_rows, (cuuint64_t)B};
  const cuuint64_t vstrides[3] = {kD * 2, (cuuint64_t)N * kD * 2,
                                  (cuuint64_t)v_rows * N * kD * 2};
  rc = make_map_bf16(&tv, v, 4, vdims, vstrides, box4);
  if (rc) return rc;
  const cuuint32_t obox[4] = {64, 1, 64, 1};
  const cuuint64_t odims[4] = {kD, (cuuint64_t)N, (cuuint64_t)sq, (cuuint64_t)B};
  const cuuint64_t ostrides[3] = {kD * 2, (cuuint64_t)N * kD * 2, (cuuint64_t)sq * N * kD * 2};
  rc = make_map_bf16(&to, out, 4, odims, ostrides, obox);
  if (rc) return rc;
  const int n_kt = (v_rows + kBN - 1) / kBN;
  const float pad = (float)(n_kt * kBN - sk_actual);
  const int n_qt = (sq + kBM - 1) / kBM;
  const int n_items = n_qt * B * N;
  kernel<<<n_items < sms ? n_items : sms, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tq, tk, tv, to, N, n_qt, n_items, n_kt, pad);
  return (int)cudaGetLastError();
}

}  // namespace

// qh: (B*N, sq_pad, 128) bf16; kh: (B*N, sk_pad, 128) bf16, rows >= v_rows
// zero; v: (B, v_rows, N, 128) bf16, 1 <= sk_actual <= v_rows <= sk_pad;
// out: (B, sq, N, 128) bf16, sq <= sq_pad.  Every pointer 16-byte aligned
// (checked by the Python wrapper, with sq_pad and sk_pad multiples of 64).
extern "C" int fg_flash_bounded(const void* qh, const void* kh, const void* v, void* out,
                                int B, int N, int sq, int sq_pad, int sk_actual,
                                int sk_pad, int v_rows, void* stream) {
  static int smem_rc = allow_smem(fa_bounded_kernel);
  return launch(fa_bounded_kernel, smem_rc, qh, kh, v, out, B, N, sq, sq_pad, sk_actual, sk_pad,
                v_rows, stream);
}

extern "C" int fg_flash_small_kv(const void* qh, const void* kh, const void* v, void* out,
                                 int B, int N, int sq, int sq_pad, int sk_actual,
                                 int sk_pad, int v_rows, void* stream) {
  static int smem_rc = allow_smem(fa_small_kv_kernel);
  return launch(fa_small_kv_kernel, smem_rc, qh, kh, v, out, B, N, sq, sq_pad, sk_actual, sk_pad,
                v_rows, stream);
}

// dynamic shared memory of either kernel, in bytes (printed by chip_smoke.py)
extern "C" int fg_flash_bounded_smem_bytes() { return kSmemBytes; }
