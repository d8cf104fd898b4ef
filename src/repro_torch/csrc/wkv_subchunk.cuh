// The WKV's sub-chunk factorisation on Hopper, shared by the forward
// (csrc/rwkv6_chunked.cu) and its gradient (csrc/rwkv6_bwd_chunked.cu):
// the head size and the staged rows' strides, cp.async staging, TF32 and
// bf16 mma.sync with float32 accumulators, and the scores A[s, t] of a
// 16-token sub-chunk (kernels/ref.py :: _subchunk_scores is them in plain
// PyTorch).  A pair of tokens in one block of 4 is summed exactly on the
// CUDA cores; a pair across blocks is the product X_s . Y_t of X_s = r_s
// prod_{g<=j<s} w_j (g the query block's start) and Y_t = k_t prod_{t<j<g}
// w_j, on the tensor cores.  The scores are rounded to TF32 as operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                   // head size: key channels, values
constexpr int SUB = 16;                 // tokens a state step
constexpr int BLK = 4;                  // tokens a score block
constexpr int BSTR = D + 8;             // bf16 row stride: 144 B
constexpr int FSTR = D + 8;             // float row stride
constexpr int NY = 24;                  // key rows of Y: 4 + 8 + 12
constexpr int ASTR = SUB + 4;           // float row stride of a score block
static_assert(SUB / BLK * 8 == 32, "eight score lanes per block");

// Y's first row of query block a (1..3): key rows t < 4a of it follow.
__host__ __device__ constexpr int y_row(int a) {
  return a == 1 ? 0 : a == 2 ? 4 : 12;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `bytes` 0 fills the 16 with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding of finite values in two integer
// operations (kernels/ref.py :: round_operand writes the same).
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Eight bf16 (16 bytes, 16-byte aligned) as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    f[2 * m] = __uint_as_float(w[m] << 16);
    f[2 * m + 1] = __uint_as_float(w[m] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// d += a b, m16n8k8, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float* d, float a0, float a1,
                                         float a2, float a3, float b0,
                                         float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// Two floats as bf16x2 (round to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// d += a b, m16n8k16, bf16 operands (two to a register), float32
// accumulators
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One halving round of the butterfly: lanes that differ in bit O swap
// halves of their N values and add.
template <int N, int O>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int m = 0; m < N / 2; ++m) {
    const float send = upper ? v[m] : v[m + N / 2];
    const float keep = upper ? v[m + N / 2] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Scores across the score blocks of one sub-chunk, on the tensor cores:
// C[s][n] = X_s . Y_n over the 64 channels (M 16, N 24, K 64), and
// A[s][t] = C[s][y_row(s / 4) + t] for t < 4 (s / 4).  The k slots of each
// 8-channel step are channels 2 tg, 2 tg + 1, so both fragments load as
// float2.  xs: the sub-chunk's 16 rows of X; ys: its 24 rows of Y.
__device__ __forceinline__ void scores_across(const float* xs,
                                              const float* ys, float* a,
                                              int lane) {
  const int gq = lane >> 2, tg = lane & 3;
  float c[3][4] = {};
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int ch = 8 * ks + 2 * tg;
    const float2 lo = *reinterpret_cast<const float2*>(xs + gq * FSTR + ch);
    const float2 hi =
        *reinterpret_cast<const float2*>(xs + (gq + 8) * FSTR + ch);
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
      const float2 y =
          *reinterpret_cast<const float2*>(ys + (8 * nt + gq) * FSTR + ch);
      mma_tf32(c[nt], lo.x, hi.x, lo.y, hi.y, y.x, y.y);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 3; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = gq + 8 * (e >> 1), n = 8 * nt + 2 * tg + (e & 1);
      const int qb = s / BLK, t = n - y_row(qb);
      if (qb >= 1 && t >= 0 && t < BLK * qb) a[s * ASTR + t] = tf32(c[nt][e]);
    }
}

// Scores within the score blocks of one sub-chunk, exact on the CUDA
// cores: lane (b, c) = (lane / 8, lane % 8) takes block b (rows rs, ks, ws
// of the sub-chunk) and channels [8c, 8c + 8): its 6 pairs, with the
// decays between them multiplied in order, and its 4 bonus terms; the
// eight lanes of a block add their 10 sums in a halving butterfly, after
// which lane c holds slots 2c, 2c + 1.
__device__ __forceinline__ void scores_within(const __nv_bfloat16* rs,
                                              const __nv_bfloat16* ks,
                                              const float* ws,
                                              const float* u8, float* a,
                                              int lane) {
  const int t0 = BLK * (lane >> 3), c8 = 8 * (lane & 7);
  float r[BLK][8], k[BLK][8], w1[8], w2[8];
#pragma unroll
  for (int m = 0; m < BLK; ++m) {
    load8(rs + (t0 + m) * BSTR + c8, r[m]);
    load8(ks + (t0 + m) * BSTR + c8, k[m]);
  }
  load8(ws + (t0 + 1) * D + c8, w1);
  load8(ws + (t0 + 2) * D + c8, w2);
  float acc[16] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float k01 = k[0][i] * w1[i], k012 = k01 * w2[i];
    const float k12 = k[1][i] * w2[i];
    acc[0] = fmaf(r[1][i], k[0][i], acc[0]);     // (1, 0)
    acc[1] = fmaf(r[2][i], k01, acc[1]);         // (2, 0)
    acc[2] = fmaf(r[2][i], k[1][i], acc[2]);     // (2, 1)
    acc[3] = fmaf(r[3][i], k012, acc[3]);        // (3, 0)
    acc[4] = fmaf(r[3][i], k12, acc[4]);         // (3, 1)
    acc[5] = fmaf(r[3][i], k[2][i], acc[5]);     // (3, 2)
#pragma unroll
    for (int m = 0; m < BLK; ++m)                // (m, m)
      acc[6 + m] = fmaf(r[m][i] * u8[i], k[m][i], acc[6 + m]);
  }
  fold<16, 4>(acc, lane);
  fold<8, 2>(acc, lane);
  fold<4, 1>(acc, lane);
  // slot n's (s, t) within the block, four bits a slot
  constexpr uint64_t kS = 0x3210333221ull, kT = 0x3210210100ull;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int n = 2 * (lane & 7) + m;
    if (n < 10)
      a[(t0 + (int)((kS >> (4 * n)) & 15)) * ASTR + t0 +
        (int)((kT >> (4 * n)) & 15)] = tf32(acc[m]);
  }
}

}  // namespace
