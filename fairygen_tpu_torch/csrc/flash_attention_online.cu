// K5, K6a and K10: flash attention with a running max (online softmax) on
// head-major bf16 q/k/v (B*N, S_pad, D), for Hopper (sm_90a); and K4's max
// and masked forms, which round p against each row's max over every key.
//
// Replaces the TPU kernels fairygen_tpu/ops/flash_attention.py:
//   K4  _fa_small_kv_kernel with bounded=False (entry flash_small_kv_max):
//                           the generic forward where the keys fit one TPU k
//                           tile (at most 1024), head dims 64 and 128 and
//                           SD1.5's 8, 40, 80 and 160; the max form, and the
//                           masked form (key columns >= sk_actual set to
//                           -1e30 first; those key and value rows may hold
//                           non-zero values)
//   K5  _fa_kernel          the generic no-gradient forward (entry flash_fwd
//                           with with_lse=False), at head dims 64 and 128
//                           and SD1.5's 8, 40, 80 and 160
//   K6a _fa_fwd_lse_kernel  the forward of the gradient path (flash_fwd with
//                           with_lse=True), head dims 64 and 128: K5 plus
//                           lse = m + log2(l), one fp32 value a row; its o
//                           equals K5's bit for bit at the same head dim
//                           (one instantiation but for the lse store)
//   K10 _fa_bias_kernel     the same with a head-shared additive bias (entry
//                           flash_attention_bias), head dim 128: FLUX.1's EliGen
// Contract: q carries hd^-1/2 * log2(e).  K5, K6a: s = q.k, key columns >=
// sk_actual get -inf (P = 0 exactly).  K10: s = q.k + bias * log2(e), added as
// __fadd_rn(s, __fmul_rn(b, log2 e)) like the plain version; the bias is
// fp32 (B|1, sq, sk) in the natural log (the attn_mask of
// scaled_dot_product_attention), row bn / N for head bn (row 0 when it has
// one); rows >= sq and columns in [sk, sk_pad) take -1e30, as the plain
// version pads it, and columns past sk_pad -inf (they are not keys of the
// plain version), so even a row masked everywhere matches it.  Online
// softmax in base 2 with a running max m: p = exp2(s - m) rounded to bf16
// before P V (against its key tile's running max), l summed in fp32 from
// the unrounded p, o = O / l.  Every row of the head-major output (and of
// K6a's lse) below sq_pad is written.  K4: m is each row's max over every
// key, p = exp2(s - m) once, l summed in fp32 from the unrounded p, p
// rounded to bf16 before P V, o = pv / l (the Pallas kernel's rounding);
// masked keys take -inf, which gives the same exact zeros as -1e30.
//
// Bounds on the H100 (989 TFLOP/s bf16):
//   - K4 max at SDXL's 40 x 1024 x 1024 x 64: 0.0109 ms (operations), at
//     24 x 2048 x 512 x 128 0.0130; the row-max pre-pass adds every S
//     product once more (1.5x the bound's count).  K4 masked at SDXL's
//     cross-attention (20 x 4096 and 40 x 1024 queries, 77 keys, d 64):
//     0.0064 and 0.0034 ms (bytes: q in, o out; a head's 16 KB K and V
//     tiles come from L2).
//   - K5 at SDXL's 20 x 4096 x 4096 x 64: 4 Sq Sk d flops a head, 0.0869
//     ms (operations).  At d 64 exp2 costs about as much as the products:
//     20 x 4096^2 = 3.4e8 exp2 on 132 SMs x 16 MUFU a clock (1.755-1.98
//     GHz) is 0.080-0.090 ms.  So the two consumer warpgroups take turns
//     (one's exp2 runs under the other's wgmma), and the masking select is
//     compiled only into the ragged form (sk_actual not a multiple of 128).
//   - K6a at head dim 64 (the bf16 SDXL UNet under a gradient: BrushNet
//     training, SDXL distillation) at 10 x 4096^2 and 20 x 1024^2 is K5 d
//     64's problem (operations, with exp2 as costly as the products: 0.0869
//     ms at 20 x 4096^2 and the same again in exp2), plus the lse store; at
//     the cross-attention's 77 keys (one 128-key tile) q in and o out bound
//     it (bytes).
//   - K6a (and K5) at the training shapes, 24 x 8190 x 8190 x 128 and 24 x
//     8190 x 512 x 128: 0.833 and 0.0521 ms (operations); exp2 (1.6e9 at
//     the self shape, 0.39-0.44 ms) is about half of the products.  On
//     the card the turns tie with their absence at the self shape and
//     gain 2-3% at the cross shape, so they stay (chip_smoke.py times a
//     copy of this file built without them).  The self shape is ragged
//     (8190 keys in 8192 rows), the cross shape aligned.
//   - K4 and K5 at SD1.5's head dims, bounded at the true d: at d 8 and 40
//     exp2 costs more than the products (K5 at 16 x 4096^2 x 40: 0.064 ms
//     of exp2, 0.043 of products), at d 80 and 160 the products; over the
//     77 text keys and the 64- to 256-token levels q in and o out (bytes),
//     at most a few microseconds, so launch and one item's chain set the
//     time.
//   - K10 at FLUX.1's EliGen 24 x 5632 x 5632: 0.394 ms (operations), exp2
//     about half of that.  The bias is 127 MB of fp32, more than the 50 MB
//     L2, and every one of the 24 heads reads it: 3.0 GB a call go through
//     L2 and through the SMs' shared memory, beside as much again of K and
//     V.  On the card, staging the bias is what keeps K10 well above the
//     operations bound: the same kernel without the copies (wrong results)
//     ran markedly faster.
//
// Design (K3's in csrc/flash_attention.cu, plus the running max):
//   - persistent: one CTA of 384 threads on each SM walks the items
//     blockIdx.x, blockIdx.x + gridDim.x, ...; an item is 128 q rows of one
//     head.  K5's and K6a's items put the q tile innermost (neighbouring
//     CTAs share a
//     head's K and V in L2); K10's put the head innermost, so the CTAs that
//     run together hold the 24 heads of a few q tiles and read that tile's
//     bias rows (128 x 5632 x 4 B = 2.9 MB) from DRAM about once and from L2
//     24 times, while each head's K and V stream past 5-6 CTAs at once;
//   - warpgroup 0 is the producer: after setmaxnreg.dec one thread issues
//     every TMA load (3-D maps (D, S_pad, B*N), 128-byte swizzle, a 64-column
//     box a row at d 64, two at d 128; a box past a head's rows reads
//     zeros); Q into one of two buffers, K and V through an mbarrier ring
//     (2 stages at d 128, 4 at d 64);
//   - warpgroups 1 and 2 (setmaxnreg.inc) each own 64 of the item's rows:
//     S = Q K^T is wgmma.m64n128k16 with both operands K-major in shared
//     memory (d/16 k-steps); P goes from registers as the A operand of
//     O += P V, with V MN-major (its natural rows), m64n128k16 at d 128 and
//     m64n64k16 at d 64;
//   - the running max in FA3's order inside each consumer: issue S_t, then
//     P_{t-1} V_{t-1}; wait for S_t, then the row max, alpha = exp2(m_old -
//     m_new), P_t and l = l alpha + sum p; wait for P_{t-1} V_{t-1}, then
//     O *= alpha.  An item's first tile starts from m = -inf, so its alpha
//     is exp2(-inf) = 0 (K5) or exp2(-inf - m) = 0 (K10, whose scores are
//     finite): the same multiply zeroes the finished item's O after it is
//     stored and restarts l.  The loop runs over all of a CTA's tiles,
//     items in a row, so an item's first S overlaps the last P V before it;
//   - K4 with one key tile (SDXL's 77 text keys) is K5's kernel: a running
//     max over one tile is the row's max, so K5's loop rounds p as K4
//     does, with one S product an item.  Such an item is short, and its
//     softmax, P V and store form the chain that bounds it, so at d 64 and
//     at most 80 keys (CLIP's 77-token context) a form of the loop takes
//     only the tile's first 80 keys (kCols): S on m64n80k16, 40 exp2 a
//     thread in place of 64, five P V k-steps in place of eight;
//   - K4 with more key tiles (kRowMax; SDXL's 1024-token self-attention):
//     a pre-pass streams each item's K tiles through the K ring ahead of
//     its K/V stream and keeps each row's max of S = Q K^T (keys >=
//     sk_actual masked); then the loop runs with that max and no running
//     one.  The loop's S are the pre-pass's bits (the same wgmma on the
//     same operands), so s - m <= 0; nothing is rescaled, and O and l
//     restart where an item does (O zeroed once it is stored).  Tried on
//     the card and no faster: an item's K tiles held from the pre-pass to
//     the loop (d 64, eight 16 KB stages), a head's K/V tile held across
//     one-tile items of one CTA, four Q buffers, exp2 predicated off for
//     masked key columns;
//   - K5's and K6a's two consumers take turns through two named barriers
//     (FA3's ping-pong): each waits for its turn before issuing its
//     products and hands the turn over after, so one's softmax runs under
//     the other's wgmma;
//   - K10's bias, 64 KB a 128 x 128 tile, does not fit beside two Q buffers
//     and the K/V ring (224 KB at d 128).  Of the three ways (consumers load
//     it into S's layout, a 64-key tile, TMA multicast across a cluster)
//     this takes none as such: where sq = sq_pad and sk = sk_pad are
//     multiples of 128 (FLUX.1's 5632; the aligned form) the producer loads
//     the tile by TMA too (a 2-D fp32 map, boxes of 32 columns by 128 rows),
//     into the room of the second Q buffer, in two 64-column halves with a
//     full and an empty mbarrier each: a consumer warp releases a half as
//     soon as it has added it to S, and the half of the next tile goes out
//     at once.  Loading it in S's layout from global memory (8 rows of 32
//     bytes a warp instruction) was slower, and so was multicasting it to
//     the 2 or 4 CTAs of a cluster that share a q tile (they wait on each
//     other every tile), or copying it by cp.async.  At other lengths (the
//     ragged form; a TMA map would need Sk % 4 == 0, and the tests use Sk =
//     333, 650, 4097) each consumer thread loads its own entries in S's
//     layout, predicated on row < sq and column < sk in asm, with the pads
//     above: columns 0-63 of tile t+1 at the end of tile t, under S_{t+1};
//     columns 64-127 into the same 32 registers once the first half is
//     added;
//   - when an item is done each consumer stores its two rows a thread, O / l
//     (the fp32 quotient correctly rounded) rounded once to bf16, from
//     registers (rows >= sq_pad skipped); K6a's lse from one thread of each
//     quad, with the finished item's max kept beside its sum (the running
//     max restarts before the store);
//   - SD1.5's head dims run the kernels of the next width up: d 8 and 40
//     those of d 64 (the 80-column form too), d 80 those of d 128, d 160
//     its own of width 192 (three boxes).  The TMA maps take the true width
//     (rows of 2d bytes, 16 and 80 at d 8 and 40) under 64-column boxes, so
//     the columns past d read zeros, which add exactly 0 to every product:
//     the error is that of d 64 / 128; the store writes only the d columns
//     (Params::d).  At 192 columns a tile is 48 KB, so d 160 keeps two Q
//     buffers but one K and one V stage (192 KB; two stages would take 288
//     KB of the 227 KB a block may have); S takes the first 10 k-steps (160
//     columns), P V is m64n192k16 and O 96 fp32 registers a thread (no
//     spill on the card);
//   - only real work: ceil(sq_pad / 128) q tiles and ceil(sk_actual / 128)
//     (K4, K5, K6a) or ceil(sk / 128) (K10) key tiles.  A 128-key box past
//     sk_pad reads zero keys (s = 0), so the mask is on whenever sk_actual
//     is not a multiple of 128 (the ragged form), K4's max form too;
//   - no branch and no loop the compiler can see sits between a wgmma's
//     issue and its wait (mbarrier waits loop inside their asm, arrivals,
//     turn hand-overs and bias loads are predicated in asm), else ptxas
//     serializes the wgmmas.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;          // q rows per item (two warpgroups of 64)
constexpr int kBN = 128;          // keys per tile
constexpr int kThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kHalf = 128 * 128;  // bytes of one 64-column box of a 128-row tile
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kTurnBar = 1;       // named barriers 1 and 2: the consumers' turns
constexpr int kBiasHalf = 128 * 64 * 4;  // 64 columns of a 128 x 128 fp32 bias tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadBias = -1e30f;

// the 64-column boxes of a tile at head dim D (D = 160: three, the third
// half zeros), and the columns of O they give (64, 128 or 192)
__host__ __device__ constexpr int boxes(int d) { return (d + 63) / 64; }

// shared-memory layout at head dim D: the Q buffers, the K and V rings,
// K10's 128 x 128 fp32 bias tile (aligned form only: it takes the second Q
// buffer's room), the mbarriers.  At D = 160 a tile is three boxes (48 KB):
// two Q buffers and one K and one V stage take 192 KB, where two stages
// would take 288 KB of the 227 KB a block may have
template <int D, bool kBiasSmem>
struct Smem {
  static constexpr int kTile = boxes(D) * kHalf;  // a 128 x D bf16 tile
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 2 : 1;
  static constexpr int kQBufs = kBiasSmem ? 1 : 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQBufs * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kB = kV + kStages * kTile;
  static constexpr int kBar = kB + (kBiasSmem ? 2 * kBiasHalf : 0);
  static constexpr int kBytes = kBar + (8 + 4 * kStages) * 8 + 1024;  // + 1024-alignment slack
};

struct Params {
  int N, n_qt, n_items, n_kt;
  int sq_pad;
  int d;               // the head dim: the columns of q, k, v and out (<= D, a multiple of 8)
  void* out;           // (BN, sq_pad, d) bf16
  float* lse;          // K6a: (BN, sq_pad) fp32
  int sk_actual;       // K4, K5, K6a: key columns >= sk_actual are masked (ragged form)
  const float* bias;   // K10: (bias_rows, sq, sk) fp32
  int bias_rows, sq, sk, sk_pad;
};

// one work item: 128 q rows from q0 of head bn = b * N + n
struct Item {
  int q0, bn, b;
};

// item w: head innermost (K10), else q tile innermost (K5)
template <bool kHeadInner>
__device__ __forceinline__ Item item_of(int w, const Params& pr) {
  Item it;
  if (kHeadInner) {
    const int rest = w / pr.N;
    it.q0 = (rest % pr.n_qt) * kBM;
    it.b = rest / pr.n_qt;
    it.bn = it.b * pr.N + w % pr.N;
  } else {
    it.q0 = (w % pr.n_qt) * kBM;
    it.bn = w / pr.n_qt;
    it.b = it.bn / pr.N;
  }
  return it;
}

// ---------------------------------------------------------------- K10's bias

// s += b * log2(e), rounded as the plain version rounds
__device__ __forceinline__ void add_scaled(float& s, float b) {
  s = __fadd_rn(s, __fmul_rn(b, kLog2e));
}

// The aligned form's shared tile, as the TMA writes it: half h = columns
// 64h .. 64h + 63 (kBiasHalf bytes), in it two 32-column boxes of 128 rows
// of 128 bytes, the 16-byte chunks of row R swizzled by R % 8.  Columns
// 8jj + 2tg + {0, 1} of rows R and R + 8 (R = this thread's first row of
// the tile) are added to s for jj = 8h .. 8h + 7.  Rows R and R ^ 1 meet in
// the same banks: two shared-memory wavefronts a read, not one.
__device__ __forceinline__ void add_bias_half(float* s, const uint8_t* tile, int R, int tg,
                                              int h) {
#pragma unroll
  for (int jj = 8 * h; jj < 8 * h + 8; ++jj) {
    const uint8_t* box = tile + h * kBiasHalf + ((jj >> 2) & 1) * (kBiasHalf / 2);
    const int chunk = ((((jj & 3) << 1) | (tg >> 1)) ^ (R & 7)) << 4;
    const float2 v0 = *reinterpret_cast<const float2*>(box + R * 128 + chunk + (tg & 1) * 8);
    const float2 v1 =
        *reinterpret_cast<const float2*>(box + (R + 8) * 128 + chunk + (tg & 1) * 8);
    add_scaled(s[4 * jj], v0.x);
    add_scaled(s[4 * jj + 1], v0.y);
    add_scaled(s[4 * jj + 2], v1.x);
    add_scaled(s[4 * jj + 3], v1.y);
  }
}

// The ragged form: this thread's bias entries of one 128-key tile, read
// from global memory straight into S's accumulator layout: rows qr and
// qr + 8 of its warpgroup, columns 8jj + 2tg + {0, 1} (jj < 16)
struct BiasTile {
  const float* p0;  // row qr, column k0 + 2tg
  const float* p1;  // row qr + 8
  int ok0, ok1;     // the rows are < sq
  int lim, plim;    // sk and sk_pad less k0 + 2tg
};

__device__ __forceinline__ BiasTile bias_tile(const Params& pr, const Item& it, int j, int qr,
                                              int tg) {
  BiasTile bt;
  const int row = it.q0 + qr, c0 = j * kBN + 2 * tg;
  const float* base = pr.bias + (size_t)(pr.bias_rows == 1 ? 0 : it.b) * pr.sq * pr.sk;
  bt.p0 = base + (size_t)row * pr.sk + c0;
  bt.p1 = bt.p0 + (size_t)8 * pr.sk;
  bt.ok0 = row < pr.sq;
  bt.ok1 = row + 8 < pr.sq;
  bt.lim = pr.sk - c0;
  bt.plim = pr.sk_pad - c0;
  return bt;
}

// v = *p where ok, else v keeps its value; predicated inside the asm
__device__ __forceinline__ void ld_if(float& v, const float* p, int ok) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "setp.ne.b32 P1, %2, 0;\n"
      "@P1 ld.global.nc.f32 %0, [%1];\n"
      "}\n"
      : "+f"(v)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(ok));
}

// columns 64h .. 64h + 63 of the tile into b[32] (b[4jj + {0,1}] row qr,
// b[4jj + {2,3}] row qr + 8, column 64h + 8jj + 2tg + {0,1}), the pads
// where the row or the column is out of range
__device__ __forceinline__ void load_bias(float* b, const BiasTile& bt, int h) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = 64 * h + 8 * jj;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float pad = c + e < bt.plim ? kPadBias : -INFINITY;
      const int col_ok = c + e < bt.lim;
      b[4 * jj + e] = pad;
      b[4 * jj + 2 + e] = pad;
      ld_if(b[4 * jj + e], bt.p0 + c + e, bt.ok0 & col_ok);
      ld_if(b[4 * jj + 2 + e], bt.p1 + c + e, bt.ok1 & col_ok);
    }
  }
}

__device__ __forceinline__ void add_bias(float* s, const float* b, int h) {
#pragma unroll
  for (int q = 0; q < 32; ++q) add_scaled(s[32 * h + q], b[q]);
}

// ------------------------------------------------------------ the softmax

// the two rows' maxima over columns 64h .. 64h + 63 (this thread's entries)
__device__ __forceinline__ void row_max(const float* s, int h, float& mx0, float& mx1) {
#pragma unroll
  for (int jj = 8 * h; jj < 8 * h + 8; ++jj) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
  }
}

// the two rows' maxima over columns 0 .. 8NJ - 1 (this thread's entries)
template <int NJ>
__device__ __forceinline__ void row_max_cols(const float* s, float& mx0, float& mx1) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
  }
}

// the ragged form: of columns 0 .. 8NJ - 1, those >= sk_actual (lim =
// sk_actual - k0 - 2tg) get -inf
template <int NJ>
__device__ __forceinline__ void mask_keys(float* s, int lim) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool out = 8 * jj + e >= lim;
      s[4 * jj + e] = out ? -INFINITY : s[4 * jj + e];
      s[4 * jj + 2 + e] = out ? -INFINITY : s[4 * jj + 2 + e];
    }
}

// the two rows' maxima across the quad that shares them
__device__ __forceinline__ void quad_max(float& mx0, float& mx1) {
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
}

// from the maxima of this thread's entries: the rows' new maxima (across the
// quad that shares them), alpha = exp2(m_old - m_new), p = exp2(s - m_new)
// in place and l = l alpha + sum p (this thread's partial sums).  K4
// (kRowMax): mx0 and mx1 are already the rows' max over every key (m0, m1),
// so nothing is rescaled (alpha is left unset): p = exp2(s - m), and l
// restarts where an item does.  Columns 0 .. 8NJ - 1 only
template <bool kRowMax, int NJ>
__device__ __forceinline__ void softmax_rows(float* s, float mx0, float mx1, float& m0,
                                             float& m1, float& l0, float& l1, float& a0,
                                             float& a1, bool restart) {
  if constexpr (kRowMax) {
    l0 = restart ? 0.f : l0;
    l1 = restart ? 0.f : l1;
  } else {
    quad_max(mx0, mx1);
    a0 = ex2(m0 - mx0);
    a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
  }
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    s[4 * jj] = ex2(s[4 * jj] - mx0);
    s[4 * jj + 1] = ex2(s[4 * jj + 1] - mx0);
    s[4 * jj + 2] = ex2(s[4 * jj + 2] - mx1);
    s[4 * jj + 3] = ex2(s[4 * jj + 3] - mx1);
    r0 += s[4 * jj] + s[4 * jj + 1];
    r1 += s[4 * jj + 2] + s[4 * jj + 3];
  }
  if constexpr (kRowMax) {
    l0 += r0;
    l1 += r1;
  } else {
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
  }
}

// the warpgroup's rows qr and qr + 8 of the item = O / l, rounded once to
// bf16, stored from registers (once an item), and with kLse (K6a) their lse
// = m + log2(l); rows >= sq_pad are skipped, and so are O's columns >= d
// (O is W columns wide: the boxes' columns, past d zeros)
template <int W, bool kLse>
__device__ __forceinline__ void store_rows(const Params& pr, const float* o, float l0, float l1,
                                           float m0, float m1, const Item& it, int qr, int tg) {
  // the four threads of a quad hold disjoint columns of the same two rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = __frcp_rn(l0), inv1 = __frcp_rn(l1);
  const int row = it.q0 + qr, pitch = pr.d / 2;  // bf16 pairs a row
  // column 8j + 2tg of the row is the bf16 pair 4j + tg
  uint32_t* dst =
      reinterpret_cast<uint32_t*>(pr.out) + ((size_t)it.bn * pr.sq_pad + row) * pitch + tg;
  if (row < pr.sq_pad) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      if (8 * j < pr.d)
        dst[4 * j] = pack_bf16(div_rn(o[4 * j], l0, inv0), div_rn(o[4 * j + 1], l0, inv0));
  }
  if (row + 8 < pr.sq_pad) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      if (8 * j < pr.d)
        dst[8 * pitch + 4 * j] =
            pack_bf16(div_rn(o[4 * j + 2], l1, inv1), div_rn(o[4 * j + 3], l1, inv1));
  }
  if constexpr (kLse) {
    // one thread of each quad (all four hold the rows' m and summed l)
    float* lse = pr.lse + (size_t)it.bn * pr.sq_pad + row;
    if (tg == 0 && row < pr.sq_pad) lse[0] = m0 + log2f(l0);
    if (tg == 0 && row + 8 < pr.sq_pad) lse[8] = m1 + log2f(l1);
  }
}

template <int D, bool kBias, bool kRagged, bool kLse, bool kRowMax, int kCols = kBN>
__device__ __forceinline__ void attend(const CUtensorMap* tq, const CUtensorMap* tk,
                                       const CUtensorMap* tv, const CUtensorMap* tb,
                                       const Params& pr) {
  constexpr bool kBiasSmem = kBias && !kRagged;  // the aligned form's shared bias tile
  // K5 and K6a: the consumers take turns, one's exp2 under the other's
  // wgmma (at d 64 faster on the card than without, at d 128 a tie or
  // better); for K10 the turns cost more than they give (its softmax, with
  // the bias, outlasts the other's wgmma).  chip_smoke.py finds this line
  // by its text to build the copy without the d-128 turns.
  constexpr bool kTurns = !kBias;
  // the key columns of a tile that S, the softmax and P V take: all 128,
  // or, for one key tile of at most kCols keys, the first kCols (80: an S
  // accumulator of 40 floats a thread, every one of them read, or ptxas
  // serializes the wgmma for want of registers, C7511)
  constexpr int kNJ = kCols / 8;
  // the boxes of a tile, and O's columns (D = 160: 192, the last 32 zeros,
  // which P V computes and the store skips)
  constexpr int kBoxes = boxes(D);
  constexpr int kW = 64 * kBoxes;
  using L = Smem<D, kBiasSmem>;
  constexpr int kStages = L::kStages;
  constexpr int kQBufs = L::kQBufs;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  uint64_t* b_full = v_empty + kStages;  // K10 aligned: the two halves of the bias tile
  uint64_t* b_empty = b_full + 2;
  uint8_t* btile = smem + L::kB;

  // this CTA's items: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int mine = (pr.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_kt = pr.n_kt;
  const int wg = threadIdx.x / 128;
  auto item = [&](int i) { return item_of<kBias>(blockIdx.x + i * gridDim.x, pr); };
  // the place in the K stream (and ring) of the loop's tile t of item i,
  // and of the pre-pass's tile j: K4 reads each item's tiles twice, the
  // pre-pass's n_kt first; the other forms each tile once, in the loop
  auto k_loop = [&](int t, int i) { return kRowMax ? t + (i + 1) * n_kt : t; };
  auto k_pre = [&](int i, int j) { return 2 * i * n_kt + j; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // one arrival per consumer warp
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 8);
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
      if constexpr (kBiasSmem) prefetch_map(tb);
      // Q of item i + 1 goes out right after item i's first K/V tile: its
      // buffer was item i - 1's, free once that item's last S product is in
      // (with one Q buffer, after item i's last tile: the buffer is item i's)
      auto load_q = [&](int i) {
        const Item it = item(i);
        const int qb = i % kQBufs;
        uint8_t* q = smem + L::kQ + qb * L::kTile;
        mbar_wait(&q_empty[qb], ((i / kQBufs) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], L::kTile);
        for (int h = 0; h < kBoxes; ++h)
          tma_load_3d(q + h * kHalf, tq, &q_full[qb], 64 * h, it.q0, it.bn);
      };
      // key tile j of head bn, the kc-th tile of the K stream, into its
      // stage of the K ring
      auto load_k = [&](int j, int bn, int kc) {
        const int s = kc % kStages;
        uint8_t* kt = smem + L::kK + s * L::kTile;
        mbar_wait(&k_empty[s], ((kc / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], L::kTile);
        for (int h = 0; h < kBoxes; ++h)
          tma_load_3d(kt + h * kHalf, tk, &k_full[s], 64 * h, j * kBN, bn);
      };
      load_q(0);
      int t = 0;
      for (int i = 0; i < mine; ++i) {
        const Item it = item(i);
        // K4: the row-max pre-pass reads the item's key tiles first
        if constexpr (kRowMax)
          for (int j = 0; j < n_kt; ++j) load_k(j, it.bn, k_pre(i, j));
        for (int j = 0; j < n_kt; ++j, ++t) {
          const int s = t % kStages;
          const uint32_t ph = (t / kStages) & 1;
          uint8_t* vt = smem + L::kV + s * L::kTile;
          load_k(j, it.bn, k_loop(t, i));
          mbar_wait(&v_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&v_full[s], L::kTile);
          for (int h = 0; h < kBoxes; ++h)
            tma_load_3d(vt + h * kHalf, tv, &v_full[s], 64 * h, j * kBN, it.bn);
          if constexpr (kBiasSmem) {
            // each half of the bias tile (two boxes of 32 columns x 128
            // rows) once both consumers have read the tile before's
            const int row = (pr.bias_rows == 1 ? 0 : it.b) * pr.sq + it.q0;
            for (int h = 0; h < 2; ++h) {
              mbar_wait(&b_empty[h], (t & 1) ^ 1);
              mbar_arrive_expect_tx(&b_full[h], kBiasHalf);
              for (int c = 0; c < 2; ++c)
                tma_load_2d(btile + h * kBiasHalf + c * (kBiasHalf / 2), tb, &b_full[h],
                            j * kBN + 64 * h + 32 * c, row);
            }
          }
          if (j == (kQBufs == 2 ? 0 : n_kt - 1) && i + 1 < mine) load_q(i + 1);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 the item's rows 0..63, warpgroup 2 64..127.
    // One loop over this CTA's tiles t = (item i, key tile j), all items in a
    // row; the finished item is stored when the next one's first tile is in.
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + (lane >> 2), tg = lane & 3;
    const int qr = cw * 64 + r;  // this thread's first row within the item
    const uint32_t base = smem_u32(smem);
    const uint32_t q_rows = base + L::kQ + cw * 64 * 128;  // this warpgroup's rows
    float o[kW / 2], sacc[64], b[kBias && kRagged ? 32 : 1];
    uint32_t p[32];
#pragma unroll
    for (int k = 0; k < kW / 2; ++k) o[k] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
    float l0_done = 0.f, l1_done = 0.f, m0_done = 0.f, m1_done = 0.f;
    const int total = mine * n_kt;
    const int lim0 = pr.sk_actual - 2 * tg;  // K4, K5 and K6a: the key limit, less 2tg
    BiasTile bt = {};
    // K10 ragged: the first half of tile t's bias into registers
    auto load_regs = [&](int t) {
      const int u = t < total ? t : total - 1;
      bt = bias_tile(pr, item(u / n_kt), u % n_kt, qr, tg);
      load_bias(b, bt, 0);
    };

    // the scores of tile t (S's wait just passed) to p.  K10 aligned: each
    // half of the bias from the shared tile, released to the producer once
    // the warp has read it; K10 ragged: from registers (the first half
    // arrived under S; the second is loaded into the same registers here);
    // K4, K5, K6a ragged: keys past sk_actual masked.
    auto scores_to_p = [&](int t, int lim, bool restart) {
      float mx0 = m0, mx1 = m1;
      if constexpr (kBiasSmem) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mbar_wait(&b_full[h], t & 1);
          add_bias_half(sacc, btile, qr, tg, h);
          __syncwarp();
          mbar_arrive_if(&b_empty[h], lane == 0);
          row_max(sacc, h, mx0, mx1);
        }
      } else if constexpr (kBias) {
        add_bias(sacc, b, 0);
        load_bias(b, bt, 1);
        row_max(sacc, 0, mx0, mx1);
        add_bias(sacc, b, 1);
        row_max(sacc, 1, mx0, mx1);
      } else {
        if constexpr (kRagged) mask_keys<kNJ>(sacc, lim);
        if constexpr (!kRowMax) row_max_cols<kNJ>(sacc, mx0, mx1);
      }
      softmax_rows<kRowMax, kNJ>(sacc, mx0, mx1, m0, m1, l0, l1, a0, a1, restart);
    };
    // K4: each row's max over every key tile of the item whose Q is in
    // buffer qb (keys >= sk_actual masked); no other wgmma is in flight
    float pm0 = -INFINITY, pm1 = -INFINITY;
    auto prepass = [&](int i, int qb) {
      pm0 = -INFINITY;
      pm1 = -INFINITY;
      for (int j = 0; j < n_kt; ++j) {
        const int kc = k_pre(i, j), s = kc % kStages;
        mbar_wait(&k_full[s], (kc / kStages) & 1);
        wgmma_fence();
        tile_scores<D>(sacc, q_rows + qb * L::kTile, base + L::kK + s * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<64>(sacc);
        mbar_arrive_if(&k_empty[s], lane == 0);
        if constexpr (kRagged) mask_keys<16>(sacc, lim0 - j * kBN);
        row_max_cols<16>(sacc, pm0, pm1);
      }
      quad_max(pm0, pm1);
    };
    if constexpr (kBias && kRagged) load_regs(0);
    // the turns: warpgroup 2 hands warpgroup 1 the first
    auto wait_turn = [&] {
      if constexpr (kTurns) named_bar_sync(kTurnBar + cw, 256);
    };
    auto pass_turn = [&](int pred) {
      if constexpr (kTurns) named_bar_arrive_if(kTurnBar + 1 - cw, 256, pred);
    };
    if constexpr (kTurns) named_bar_arrive_if(kTurnBar, 256, cw == 1);

    mbar_wait(&q_full[0], 0);
    if constexpr (kRowMax) {
      prepass(0, 0);
      m0 = pm0;
      m1 = pm1;
    }
    const int kc0 = k_loop(0, 0), s0 = kc0 % kStages;
    mbar_wait(&k_full[s0], (kc0 / kStages) & 1);
    wait_turn();
    wgmma_fence();
    tile_scores<D, kCols>(sacc, q_rows, base + L::kK + s0 * L::kTile);
    wgmma_commit();
    pass_turn(1);
    wgmma_wait<0>();
    fence_regs<kNJ * 4>(sacc);
    mbar_arrive_if(&k_empty[s0], lane == 0);
    mbar_arrive_if(&q_empty[0], lane == 0 && n_kt == 1);
    scores_to_p(0, lim0, true);
    to_a_fragments<kNJ / 2>(sacc, p);
    if constexpr (kBias && kRagged) load_regs(1);

    int i = 0, j = 0;
    for (int t = 1; t < total; ++t) {
      if (++j == n_kt) {
        j = 0;
        ++i;
      }
      const int qb = i % kQBufs;
      if (j == 0) {
        mbar_wait(&q_full[qb], (i / kQBufs) & 1);
        if constexpr (kRowMax) prepass(i, qb);
      }
      const int kc = k_loop(t, i);
      const int s = kc % kStages, sp = (t - 1) % kStages;
      const uint32_t ph = (kc / kStages) & 1, php = ((t - 1) / kStages) & 1;
      mbar_wait(&k_full[s], ph);
      wait_turn();
      fence_regs<kW / 2>(o);
      fence_regs<kNJ * 2>(p);
      wgmma_fence();
      tile_scores<D, kCols>(sacc, q_rows + qb * L::kTile, base + L::kK + s * L::kTile);
      wgmma_commit();
      mbar_wait(&v_full[sp], php);
      tile_pv<kW, kNJ / 2>(o, p, base + L::kV + sp * L::kTile);
      wgmma_commit();
      pass_turn(1);
      wgmma_wait<1>();  // S of tile t is in; P V of tile t-1 still runs
      fence_regs<kNJ * 4>(sacc);
      mbar_arrive_if(&k_empty[s], lane == 0);
      mbar_arrive_if(&q_empty[qb], lane == 0 && j == n_kt - 1);
      // a new item: the sums and maxima so far are the finished item's, and
      // its running max restarts (alpha = 0 below); K4's starts from the
      // pre-pass's maxima
      l0_done = j == 0 ? l0 : l0_done;
      l1_done = j == 0 ? l1 : l1_done;
      m0_done = j == 0 ? m0 : m0_done;
      m1_done = j == 0 ? m1 : m1_done;
      m0 = j == 0 ? (kRowMax ? pm0 : -INFINITY) : m0;
      m1 = j == 0 ? (kRowMax ? pm1 : -INFINITY) : m1;
      // the ragged form masks only the item's last tile (lim > 121 before)
      scores_to_p(t, lim0 - j * kBN, j == 0);
      wgmma_wait<0>();
      fence_regs<kW / 2>(o);
      mbar_arrive_if(&v_empty[sp], lane == 0);
      if (j == 0) {
        store_rows<kW, kLse>(pr, o, l0_done, l1_done, m0_done, m1_done, item(i - 1), qr, tg);
        if constexpr (kRowMax) {
#pragma unroll
          for (int k = 0; k < kW / 2; ++k) o[k] = 0.f;
        }
      }
      if constexpr (!kRowMax) {
#pragma unroll
        for (int k = 0; k < kW / 8; ++k) {
          o[4 * k] *= a0;
          o[4 * k + 1] *= a0;
          o[4 * k + 2] *= a1;
          o[4 * k + 3] *= a1;
        }
      }
      to_a_fragments<kNJ / 2>(sacc, p);
      if constexpr (kBias && kRagged) load_regs(t + 1);
    }
    const int sl = (total - 1) % kStages;
    mbar_wait(&v_full[sl], ((total - 1) / kStages) & 1);
    wait_turn();
    fence_regs<kW / 2>(o);
    fence_regs<kNJ * 2>(p);
    wgmma_fence();
    tile_pv<kW, kNJ / 2>(o, p, base + L::kV + sl * L::kTile);
    wgmma_commit();
    pass_turn(cw == 0);  // warpgroup 2's last hand-over would have no taker
    wgmma_wait<0>();
    fence_regs<kW / 2>(o);
    store_rows<kW, kLse>(pr, o, l0, l1, m0, m1, item(mine - 1), qr, tg);
  }
}

// K5 at head dim 64, sk_actual a multiple of 128 (SDXL's 4096): no mask
__global__ void __launch_bounds__(kThreads, 1)
fa_online_d64_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<64, false, false, false, false>(&tq, &tk, &tv, &tb, pr);
}

// K5 at head dim 64, keys >= sk_actual masked in the last tile
__global__ void __launch_bounds__(kThreads, 1)
fa_online_d64_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<64, false, true, false, false>(&tq, &tk, &tv, &tb, pr);
}

// K5 at head dim 128, sk_actual a multiple of 128 (the training cross
// shape's 512 keys)
__global__ void __launch_bounds__(kThreads, 1)
fa_online_d128_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<128, false, false, false, false>(&tq, &tk, &tv, &tb, pr);
}

// K5 at head dim 128, keys >= sk_actual masked in the last tile (the
// training self shape: 8190 keys)
__global__ void __launch_bounds__(kThreads, 1)
fa_online_d128_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<128, false, true, false, false>(&tq, &tk, &tv, &tb, pr);
}

// K6a: K5 at head dim 128 plus the lse, aligned
__global__ void __launch_bounds__(kThreads, 1)
fa_online_lse_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<128, false, false, true, false>(&tq, &tk, &tv, &tb, pr);
}

// K6a, ragged
__global__ void __launch_bounds__(kThreads, 1)
fa_online_lse_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<128, false, true, true, false>(&tq, &tk, &tv, &tb, pr);
}

// K6a at head dim 64 (the bf16 SDXL UNet's gradient path), aligned
__global__ void __launch_bounds__(kThreads, 1)
fa_online_lse_d64_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<64, false, false, true, false>(&tq, &tk, &tv, &tb, pr);
}

// K6a at head dim 64, ragged (the cross-attention's 77 text keys)
__global__ void __launch_bounds__(kThreads, 1)
fa_online_lse_d64_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<64, false, true, true, false>(&tq, &tk, &tv, &tb, pr);
}

// K10, sq = sq_pad and sk = sk_pad multiples of 128 (FLUX.1's 5632): the
// bias through shared memory
__global__ void __launch_bounds__(kThreads, 1)
fa_online_bias_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<128, true, false, false, false>(&tq, &tk, &tv, &tb, pr);
}

// K10 at any other lengths (odd Sk included): predicated loads and pads
__global__ void __launch_bounds__(kThreads, 1)
fa_online_bias_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<128, true, true, false, false>(&tq, &tk, &tv, &tb, pr);
}

// K4 over one tile of at most 80 keys at head dim 64 (SDXL's 77 text keys,
// CLIP's context): K5's loop on the tile's first 80 columns
__global__ void __launch_bounds__(kThreads, 1)
fa_online_d64_k80_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<64, false, true, false, false, 80>(&tq, &tk, &tv, &tb, pr);
}

// K4's max and masked forms over more than one key tile at head dim 64,
// sk_actual a multiple of 128 (SDXL's 1024-token self-attention)
__global__ void __launch_bounds__(kThreads, 1)
fa_row_max_d64_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<64, false, false, false, true>(&tq, &tk, &tv, &tb, pr);
}

// K4 over more than one key tile at head dim 64, keys >= sk_actual masked
__global__ void __launch_bounds__(kThreads, 1)
fa_row_max_d64_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<64, false, true, false, true>(&tq, &tk, &tv, &tb, pr);
}

// K4 over more than one key tile at head dim 128, sk_actual a multiple of 128
__global__ void __launch_bounds__(kThreads, 1)
fa_row_max_d128_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<128, false, false, false, true>(&tq, &tk, &tv, &tb, pr);
}

// K4 over more than one key tile at head dim 128, keys >= sk_actual masked
__global__ void __launch_bounds__(kThreads, 1)
fa_row_max_d128_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<128, false, true, false, true>(&tq, &tk, &tv, &tb, pr);
}

// K5 and K4 over one key tile at head dim 160 (SD1.5's 1280-channel
// levels), sk_actual a multiple of 128
__global__ void __launch_bounds__(kThreads, 1)
fa_online_d160_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<160, false, false, false, false>(&tq, &tk, &tv, &tb, pr);
}

// K5 and K4 over one key tile at head dim 160, keys >= sk_actual masked (the
// mid block's 64 tokens and the 77 text keys)
__global__ void __launch_bounds__(kThreads, 1)
fa_online_d160_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<160, false, true, false, false>(&tq, &tk, &tv, &tb, pr);
}

// K4 over more than one key tile at head dim 160, sk_actual a multiple of 128
// (SD1.5's 256-token self-attention at 512x512)
__global__ void __launch_bounds__(kThreads, 1)
fa_row_max_d160_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<160, false, false, false, true>(&tq, &tk, &tv, &tb, pr);
}

// K4 over more than one key tile at head dim 160, keys >= sk_actual masked
// (576 and 144 tokens at 768x768)
__global__ void __launch_bounds__(kThreads, 1)
fa_row_max_d160_ragged_kernel(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tb, const Params pr) {
  attend<160, false, true, false, true>(&tq, &tk, &tv, &tb, pr);
}

typedef void (*OnlineKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                             const CUtensorMap, const Params);

// the kernel's shared-memory limit, set once per kernel (a static in each
// entry); 0 or a cudaError_t value
template <int D, bool kBiasSmem>
int allow_smem(OnlineKernel kernel) {
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Smem<D, kBiasSmem>::kBytes);
}

// q, out: (BN, sq_pad, d); k, v: (BN, sk_pad, d), d = pr.d <= D; pr's N,
// n_kt, d, out and the mask or bias fields set.  The maps have the true
// width d (rows of 2d bytes), so where d < D the boxes' columns past d read
// zeros, which add exactly 0 to every product: d 8 and 40 run the D-64
// kernels, d 80 the D-128 ones
template <int D, bool kBiasSmem>
int launch(OnlineKernel kernel, int smem_rc, const void* qh, const void* kh, const void* vh,
           int BN, int sq_pad, int sk_pad, Params pr, void* stream) {
  if (smem_rc) return smem_rc;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  if (pr.d < 8 || pr.d > D || pr.d % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tb;
  const cuuint32_t box[3] = {64, kBM, 1};
  const cuuint64_t d = pr.d;
  const cuuint64_t qdims[3] = {d, (cuuint64_t)sq_pad, (cuuint64_t)BN};
  const cuuint64_t qstrides[2] = {d * 2, (cuuint64_t)sq_pad * d * 2};
  int rc = make_map_bf16(&tq, qh, 3, qdims, qstrides, box);
  if (rc) return rc;
  const cuuint64_t kdims[3] = {d, (cuuint64_t)sk_pad, (cuuint64_t)BN};
  const cuuint64_t kstrides[2] = {d * 2, (cuuint64_t)sk_pad * d * 2};
  if ((rc = make_map_bf16(&tk, kh, 3, kdims, kstrides, box))) return rc;
  if ((rc = make_map_bf16(&tv, vh, 3, kdims, kstrides, box))) return rc;
  tb = tq;  // read only by the aligned K10 kernel
  if (kBiasSmem) {
    // the bias as (sk, bias_rows * sq) fp32 in boxes of 32 columns (128
    // bytes) by 128 rows
    const cuuint64_t bdims[2] = {(cuuint64_t)pr.sk, (cuuint64_t)pr.bias_rows * pr.sq};
    const cuuint64_t bstrides[1] = {(cuuint64_t)pr.sk * 4};
    const cuuint32_t bbox[2] = {32, kBM};
    if ((rc = make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, pr.bias, 2, bdims, bstrides, bbox)))
      return rc;
  }
  pr.sq_pad = sq_pad;
  pr.n_qt = (sq_pad + kBM - 1) / kBM;
  pr.n_items = pr.n_qt * BN;
  kernel<<<pr.n_items < sms ? pr.n_items : sms, kThreads, Smem<D, kBiasSmem>::kBytes,
           (cudaStream_t)stream>>>(tq, tk, tv, tb, pr);
  return (int)cudaGetLastError();
}

// K4, K5 and K6a: the fields the launch does not set
Params fwd_params(void* out, void* lse, int sk_actual, int d) {
  Params pr = {};
  pr.N = 1;
  pr.d = d;
  pr.n_kt = (sk_actual + kBN - 1) / kBN;
  pr.out = out;
  pr.lse = (float*)lse;
  pr.sk_actual = sk_actual;
  return pr;
}

// K5's kernels and, over more than one key tile, K4's row-max ones:
// [row max][width 64, 128, 160][ragged], each with its shared-memory limit
// set once (0 or a cudaError_t value)
struct FwdKernels {
  OnlineKernel kernel[2][3][2];
  int rc[2][3][2];
};

const FwdKernels& fwd_kernels() {
  static const FwdKernels t = {
      {{{fa_online_d64_kernel, fa_online_d64_ragged_kernel},
        {fa_online_d128_kernel, fa_online_d128_ragged_kernel},
        {fa_online_d160_kernel, fa_online_d160_ragged_kernel}},
       {{fa_row_max_d64_kernel, fa_row_max_d64_ragged_kernel},
        {fa_row_max_d128_kernel, fa_row_max_d128_ragged_kernel},
        {fa_row_max_d160_kernel, fa_row_max_d160_ragged_kernel}}},
      {{{allow_smem<64, false>(fa_online_d64_kernel),
         allow_smem<64, false>(fa_online_d64_ragged_kernel)},
        {allow_smem<128, false>(fa_online_d128_kernel),
         allow_smem<128, false>(fa_online_d128_ragged_kernel)},
        {allow_smem<160, false>(fa_online_d160_kernel),
         allow_smem<160, false>(fa_online_d160_ragged_kernel)}},
       {{allow_smem<64, false>(fa_row_max_d64_kernel),
         allow_smem<64, false>(fa_row_max_d64_ragged_kernel)},
        {allow_smem<128, false>(fa_row_max_d128_kernel),
         allow_smem<128, false>(fa_row_max_d128_ragged_kernel)},
        {allow_smem<160, false>(fa_row_max_d160_kernel),
         allow_smem<160, false>(fa_row_max_d160_ragged_kernel)}}}};
  return t;
}

// K5 (row_max false) or K4 over more than one key tile (row_max true) at
// head dim d, on the kernels of the next width up; with `narrow`, at width
// 64 and at most 80 keys, the 80-column form
int launch_fwd(bool row_max, bool narrow, const void* qh, const void* kh, const void* vh,
               void* out, int BN, int sq_pad, int sk_actual, int sk_pad, int d, void* stream) {
  static const int rc80 = allow_smem<64, false>(fa_online_d64_k80_kernel);
  const FwdKernels& t = fwd_kernels();
  const int w = d <= 64 ? 0 : d <= 128 ? 1 : 2, ragged = sk_actual % kBN != 0;
  narrow = narrow && w == 0 && sk_actual <= 80;
  const OnlineKernel kernel = narrow ? fa_online_d64_k80_kernel : t.kernel[row_max][w][ragged];
  const int smem_rc = narrow ? rc80 : t.rc[row_max][w][ragged];
  const Params pr = fwd_params(out, nullptr, sk_actual, d);
  if (w == 0)
    return launch<64, false>(kernel, smem_rc, qh, kh, vh, BN, sq_pad, sk_pad, pr, stream);
  if (w == 1)
    return launch<128, false>(kernel, smem_rc, qh, kh, vh, BN, sq_pad, sk_pad, pr, stream);
  return launch<160, false>(kernel, smem_rc, qh, kh, vh, BN, sq_pad, sk_pad, pr, stream);
}

}  // namespace

// K5 at head dim d: 64 (SDXL), 128 (the Wan DiTs' training), and 8 <= d <=
// 160, a multiple of 8 (SD1.5's 8, 40, 80 and 160), on the kernels of the
// next width up (64, 128 or 160) with maps of the true width.  qh, out:
// (BN, sq_pad, d) bf16; kh, vh: (BN, sk_pad, d) bf16; 1 <= sk_actual <=
// sk_pad; sq_pad and sk_pad multiples of 64; every pointer 16-byte aligned
// (checked by the Python wrapper).
extern "C" int fg_flash_fwd(const void* qh, const void* kh, const void* vh, void* out, int BN,
                            int sq_pad, int sk_actual, int sk_pad, int d, void* stream) {
  return launch_fwd(false, false, qh, kh, vh, out, BN, sq_pad, sk_actual, sk_pad, d, stream);
}

// K6a at head dim d = 64 or 128: K5 plus lse: (BN, sq_pad) fp32; otherwise
// as fg_flash_fwd.
extern "C" int fg_flash_fwd_lse(const void* qh, const void* kh, const void* vh, void* out,
                                void* lse, int BN, int sq_pad, int sk_actual, int sk_pad, int d,
                                void* stream) {
  static int rc_even = allow_smem<128, false>(fa_online_lse_kernel);
  static int rc_ragged = allow_smem<128, false>(fa_online_lse_ragged_kernel);
  static int rc64_even = allow_smem<64, false>(fa_online_lse_d64_kernel);
  static int rc64_ragged = allow_smem<64, false>(fa_online_lse_d64_ragged_kernel);
  const bool ragged = sk_actual % kBN != 0;
  const Params pr = fwd_params(out, lse, sk_actual, d);
  if (d == 64)
    return launch<64, false>(ragged ? fa_online_lse_d64_ragged_kernel : fa_online_lse_d64_kernel,
                             ragged ? rc64_ragged : rc64_even, qh, kh, vh, BN, sq_pad, sk_pad,
                             pr, stream);
  if (d != 128) return (int)cudaErrorInvalidValue;
  return launch<128, false>(ragged ? fa_online_lse_ragged_kernel : fa_online_lse_kernel,
                            ragged ? rc_ragged : rc_even, qh, kh, vh, BN, sq_pad, sk_pad, pr,
                            stream);
}

// K4's max form (sk_actual == sk_pad) and masked form (sk_actual < sk_pad)
// at head dim d, as fg_flash_fwd takes it, over keys that are one TPU k
// tile: 1 <= sk_actual <= sk_pad <= 1024; otherwise as fg_flash_fwd.  One
// of the card's key tiles (sk_actual <= 128) runs K5's kernels (at width
// 64 and at most 80 keys, on the tile's first 80 columns), more the
// row-max kernels; the ragged kernels mask keys >= sk_actual.
extern "C" int fg_flash_small_kv_max(const void* qh, const void* kh, const void* vh, void* out,
                                     int BN, int sq_pad, int sk_actual, int sk_pad, int d,
                                     void* stream) {
  const bool many = (sk_actual + kBN - 1) / kBN > 1;
  return launch_fwd(many, true, qh, kh, vh, out, BN, sq_pad, sk_actual, sk_pad, d, stream);
}

// K10.  qh, out: (BN, sq_pad, 128) bf16; kh, vh: (BN, sk_pad, 128) bf16;
// bias: (bias_rows, sq, sk) fp32 contiguous, bias_rows 1 or BN / N; 1 <= sq
// <= sq_pad, 1 <= sk <= sk_pad, both pads multiples of 64; every pointer
// 16-byte aligned (checked by the Python wrapper).
extern "C" int fg_flash_bias(const void* qh, const void* kh, const void* vh, const void* bias,
                             void* out, int BN, int N, int bias_rows, int sq, int sq_pad, int sk,
                             int sk_pad, void* stream) {
  static int rc_even = allow_smem<128, true>(fa_online_bias_kernel);
  static int rc_ragged = allow_smem<128, false>(fa_online_bias_ragged_kernel);
  Params pr = {};
  pr.N = N;
  pr.d = 128;
  pr.n_kt = (sk + kBN - 1) / kBN;
  pr.out = out;
  pr.bias = (const float*)bias;
  pr.bias_rows = bias_rows;
  pr.sq = sq;
  pr.sk = sk;
  pr.sk_pad = sk_pad;
  if (sq == sq_pad && sk == sk_pad && sq % kBM == 0 && sk % kBN == 0)
    return launch<128, true>(fa_online_bias_kernel, rc_even, qh, kh, vh, BN, sq_pad, sk_pad, pr,
                             stream);
  return launch<128, false>(fa_online_bias_ragged_kernel, rc_ragged, qh, kh, vh, BN, sq_pad,
                            sk_pad, pr, stream);
}

// dynamic shared memory of the kernels in bytes (printed by chip_smoke.py):
// which 0, K4, K5 and K6a at head dim 64 (and K4, K5 at 8 and 40); 1, K4,
// K5 and K6a at 128 (and K4, K5 at 80) and K10's ragged form; 2, K10's
// aligned form (the bias tile in the second Q buffer's room); 3, K4 and K5
// at head dim 160
extern "C" int fg_flash_online_smem_bytes(int which) {
  return which == 0   ? Smem<64, false>::kBytes
         : which == 1 ? Smem<128, false>::kBytes
         : which == 2 ? Smem<128, true>::kBytes
                      : Smem<160, false>::kBytes;
}
