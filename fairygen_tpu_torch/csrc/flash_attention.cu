// K3 and K4: max-free ("bounded logits") attention on head-major q/k,
// writing the natural (B, S, N*128) layout.
//
// Replaces the TPU kernels fairygen_tpu/ops/flash_attention.py:
//   K3 _fa_kernel_bounded   (several k tiles; entry flash_attention_heads_major)
//   K4 _fa_small_kv_kernel  (one k tile, bounded form with pad_correct)
// Contract (shared with ops/fused_qk): q is prescaled by hd^-1/2 * log2(e)
// and both q and k are rms-normed, so |logit| < 17 and softmax ==
// exp2(s) / sum(exp2(s)) with no running max.  k rows >= sk_actual are exact
// zeros, so each adds exactly exp2(0) = 1 to the row sum and nothing to the
// output: l -= (sk_pad - sk_actual) replaces any column mask.  v is read in
// its natural (B, Lv, N, 128) layout; rows >= Lv are zero.
//
// Bound on the H100: operations (4 * Sq * Sk * 128 flops per head, far
// above the ridge).  Design: each CTA owns 64 query rows of one head
// (4 warps x 16 rows); q stays in registers as mma A fragments for the
// whole key loop; a loop over 64-key tiles INSIDE the CTA replaces the
// TPU's sequential grid axis.  Per tile, K (row-major) and V (transposed)
// are staged in padded shared memory (conflict-free 32-bit fragment
// reads), S = Q K^T and O += P V run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), and the S accumulators
// become the P A-fragments without a shuffle.  No TMA / wgmma / pipelining
// yet: this is the first, simple kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBr = 64;   // query rows per CTA
constexpr int kBc = 64;   // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kKStride = kD + 8;   // bf16 elements per K row in smem (bank padding)
constexpr int kVStride = kBc + 8;  // bf16 elements per transposed-V row in smem

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ qh,
                                       const __nv_bfloat16* __restrict__ kh,
                                       const __nv_bfloat16* __restrict__ v,
                                       __nv_bfloat16* __restrict__ out, int N, int sq,
                                       int sq_pad, int sk_actual, int sk_pad, int v_rows,
                                       __nv_bfloat16* Ks, __nv_bfloat16* Vt) {
  const int bn = blockIdx.y;
  const int b = bn / N, n = bn % N;
  const int q0 = blockIdx.x * kBr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;

  // q rows q0 + warp*16 + {g, g+8} as A fragments for the 8 k-steps of d=128
  const __nv_bfloat16* qb = qh + ((size_t)bn * sq_pad + q0 + warp * 16) * kD;
  uint32_t qa[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    qa[ks][0] = ld32(qb + g * kD + ks * 16 + tg * 2);
    qa[ks][1] = ld32(qb + (g + 8) * kD + ks * 16 + tg * 2);
    qa[ks][2] = ld32(qb + g * kD + ks * 16 + 8 + tg * 2);
    qa[ks][3] = ld32(qb + (g + 8) * kD + ks * 16 + 8 + tg * 2);
  }

  float o[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  const __nv_bfloat16* kb = kh + (size_t)bn * sk_pad * kD;
  for (int k0 = 0; k0 < sk_pad; k0 += kBc) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBc * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = i % (kD / 8);
      *reinterpret_cast<uint4*>(Ks + r * kKStride + c * 8) =
          *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kD + c * 8);
    }
    // V: consecutive threads take consecutive keys, so the transposed
    // 2-byte stores of a warp land on consecutive smem words
    for (int i = threadIdx.x; i < kBc * (kD / 8); i += kThreads) {
      const int r = i % kBc, c = i / kBc;
      const int key = k0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key < v_rows)
        val = *reinterpret_cast<const uint4*>(v + (((size_t)b * v_rows + key) * N + n) * kD + c * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c * 8 + j) * kVStride + r] = e[j];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * kKStride + ks * 16 + tg * 2;
        mma_bf16(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = exp2f(s[nt][i]);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        const __nv_bfloat16* vp = Vt + (dt * 8 + g) * kVStride + kk * 16 + tg * 2;
        mma_bf16(o[dt], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // the four threads of a quad hold disjoint columns of the same two rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float pad = (float)(sk_pad - sk_actual);
  l0 -= pad;
  l1 -= pad;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int col = dt * 8 + tg * 2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * sq + r0) * N + n) * kD + col) =
          pack_bf16(__fdiv_rn(o[dt][0], l0), __fdiv_rn(o[dt][1], l0));
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * sq + r1) * N + n) * kD + col) =
          pack_bf16(__fdiv_rn(o[dt][2], l1), __fdiv_rn(o[dt][3], l1));
  }
}

// K3: many k tiles (self-attention, s_pad > 1024)
__global__ void __launch_bounds__(kThreads)
fa_bounded_kernel(const __nv_bfloat16* __restrict__ qh, const __nv_bfloat16* __restrict__ kh,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int N,
                  int sq, int sq_pad, int sk_actual, int sk_pad, int v_rows) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBc * kKStride];
  __shared__ __align__(16) __nv_bfloat16 Vt[kD * kVStride];
  attend(qh, kh, v, out, N, sq, sq_pad, sk_actual, sk_pad, v_rows, Ks, Vt);
}

// K4: the whole key range is one TPU k tile (text cross-attention, Lk = 512)
__global__ void __launch_bounds__(kThreads)
fa_small_kv_kernel(const __nv_bfloat16* __restrict__ qh, const __nv_bfloat16* __restrict__ kh,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int N,
                   int sq, int sq_pad, int sk_actual, int sk_pad, int v_rows) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBc * kKStride];
  __shared__ __align__(16) __nv_bfloat16 Vt[kD * kVStride];
  attend(qh, kh, v, out, N, sq, sq_pad, sk_actual, sk_pad, v_rows, Ks, Vt);
}

}  // namespace

// qh: (B*N, sq_pad, 128) bf16; kh: (B*N, sk_pad, 128) bf16, rows >= sk_actual
// zero; v: (B, v_rows, N, 128) bf16; out: (B, sq, N, 128) bf16.  sq_pad and
// sk_pad are multiples of 64 (checked by the Python wrapper).
extern "C" int fg_flash_bounded(const void* qh, const void* kh, const void* v, void* out,
                                int B, int N, int sq, int sq_pad, int sk_actual,
                                int sk_pad, int v_rows, void* stream) {
  dim3 grid(sq_pad / kBr, B * N);
  fa_bounded_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qh, (const __nv_bfloat16*)kh, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, N, sq, sq_pad, sk_actual, sk_pad, v_rows);
  return (int)cudaGetLastError();
}

extern "C" int fg_flash_small_kv(const void* qh, const void* kh, const void* v, void* out,
                                 int B, int N, int sq, int sq_pad, int sk_actual,
                                 int sk_pad, int v_rows, void* stream) {
  dim3 grid(sq_pad / kBr, B * N);
  fa_small_kv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qh, (const __nv_bfloat16*)kh, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, N, sq, sq_pad, sk_actual, sk_pad, v_rows);
  return (int)cudaGetLastError();
}
