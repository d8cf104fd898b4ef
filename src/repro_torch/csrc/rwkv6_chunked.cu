// RWKV-6 (Finch) WKV in sub-chunks on the tensor cores: the bf16 prefill
// route of the WKV on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_scan.py :: rwkv6_scan (Pallas body
//   _wkv_kernel, pallas_call at :64) for the calls that
//   kernels/rwkv6_scan.py :: route sends here: bf16 r, k, v and out, D 64,
//   L at or above its threshold (the rwkv6-3b prefill).  It computes the
//   function of csrc/rwkv6_scan.cu: w (B, L, H, D) float32, u (H, D)
//   float32, state (B, H, D, D) float32 read at entry and written back at
//   exit; for each (b, h), with S the state before token t,
//     out_t = r_t . (S + diag(u) k_t v_t^T),  S <- diag(w_t) S + k_t v_t^T.
//
// Bound on the H100 at the rwkv6-3b prefill (B 2, L 5000, H 40, D 64):
//   bytes.  It must move 309.8 MB (r, k, v 153.6 MB, w 102.4 MB, out 51.2
//   MB, the state 2.6 MB read and written), 92.49 us at 3.35 TB/s.  Its
//   products, 2 D^2 + 16 D multiply-adds a (token, head), are 7.4 GFLOP,
//   15 us at the TF32 rate (495 TFLOP/s); the exact scores and the decays
//   below, about 0.75 GFLOP of float32 on the CUDA cores, 11 us at 67
//   TFLOP/s.
//
// Design.  The tokens go in sub-chunks of SUB = 16, the state steps once a
//   sub-chunk (kernels/ref.py :: wkv_subchunk_ref is this form in plain
//   PyTorch).  With S the state at a sub-chunk's start, E_s = prod_{j<s}
//   w_j, F_t = prod_{t<j<16} w_j and E = prod_j w_j:
//     out_s = (r_s * E_s) . S + sum_{t<=s} A[s,t] v_t
//     A[s,t] = sum_i r_s,i k_t,i prod_{t<j<s} w_j,i (t < s),
//     A[s,s] = sum_i r_s,i u_i k_s,i
//     S <- diag(E) S + sum_t (k_t * F_t) v_t^T
//   - Work split: one block of 8 warps for each (b, h), 80 blocks at the
//     served shape.  The decays, r * E, k * F and the scores do not depend
//     on the value column, so the block computes them once for all 64
//     columns and reads r, k, w from device memory once.  Split by value
//     column (320 blocks of 16 columns), each block would recompute them:
//     4x the score work and 4x the reads of r, k, w (from L2).  The 52
//     idle SMs cost nothing while the reads set the pace: each block keeps
//     two 64-token chunks (88 KB) in flight, 7 MB over the card.
//   - Chunk loop: the block walks the sequence in CHUNK = 64 tokens,
//     staged by 16-byte cp.async into a ring of STAGES = 3 buffers, two
//     chunks ahead of the one it computes; rows past L arrive as zeros
//     (5000 = 78 * 64 + 8: the last chunk is ragged) and count as w = 1.
//     Three barriers a chunk: decays, scores, products.
//   - No decay is ever divided by another: E_s, F_t and the scores' decays
//     are running products of w's <= 1 (no exp or log), so they underflow
//     where the true decay does and never overflow (the log-space chunked
//     form overflows at w near 1e-3: kernels/ref.py :: wkv_chunked_ref).
//     A sub-chunk's state step replaces every off-diagonal score block of
//     a longer chunk.
//   - Scores: a pair in one block of 4 tokens is summed exactly on the
//     CUDA cores (lane (block, 8 channels), the decays between multiplied
//     in order, the 8 lanes of a block adding their 10 sums in a 14-step
//     butterfly).  A pair across blocks is factored at the start g of the
//     query's block: X_s = r_s prod_{g<=j<s} w_j and Y_t = k_t prod_{t<j<g}
//     w_j, both <= |r|, |k| (Y is built from t's block suffix times each
//     whole block between), and the 96 such pairs of a sub-chunk are one
//     16 x 24 x 64 product on the tensor cores.  (Walking all 120 pairs on
//     the CUDA cores measured slower: the channel sums need a cross-lane
//     reduction, and spreading the keys re-reads the rows.)
//   - Products on the tensor cores: mma.sync m16n8k8 TF32 with float32
//     accumulation.  Product warp p (of 4) owns value columns [16p, 16p +
//     16) of the state, held transposed (S^T, 16 x 64 float32) in its
//     accumulator registers for the whole sequence, so the state crosses
//     device memory once in and once out.  A sub-chunk takes 24 mmas for
//     (r * E) . S (S^T's accumulator layout is the B fragment of this
//     product, with the k slots of each 8-channel step permuted to
//     channels 2t, 2t + 1, as the A fragment reads r * E; S goes as hi +
//     lo, hi in 16 TF32 mmas, lo in 8 bf16 ones), 4 for A v and 16 for
//     the state step; the output leaves from the accumulators as bf16.  Bound on the SM: shared-memory reads, not the tensor cores:
//     each product warp reads r * E and k * F of every channel (8 KB a
//     sub-chunk), so 4 warps read them 4 times; 2 warps of 32 columns read
//     them twice but leave two SM quarters' tensor cores idle and measured
//     slower.
//   - Rounding: every product operand is TF32 (cvt.rna's rounding): r * E,
//     X, Y, A, k * F and S's hi term; v is bf16 and exact; S's lo term
//     (S - hi, 2^-11 of S) and r * E are bf16 in its product, 2^-20 of
//     the whole.  bf16 operands throughout read about 9x the error of
//     TF32 against float32 operands (tests/test_torch_rwkv6_chunked.py,
//     400 tokens at the served decays: output 3.2e-3 against 3.4e-4 of
//     max|out|, state 2.8e-3 against 3.2e-4).  S rounded once to TF32
//     measured 9.0e-3 of an output row at w near 1e-6 on the H100
//     (chip_smoke.py phase 3), where a row's r . k cancels:
//     S's rounding is the error there.
//   - No atomics; every sum has one order: two launches agree bit for bit.
//   The staging and mma helpers and the two score functions live in
//   csrc/wkv_subchunk.cuh, which the gradient (csrc/rwkv6_bwd_chunked.cu)
//   includes too.
#include "wkv_subchunk.cuh"

namespace {

constexpr int CHUNK = 64;               // tokens a staged chunk
constexpr int NSUB = CHUNK / SUB;
constexpr int STAGES = 3;               // staged chunks in the ring
constexpr int THREADS = 256;            // 8 warps
constexpr int PW = 4;                   // product warps: value tiles
constexpr int VT = D / PW;              // value columns a product warp
constexpr int MT = VT / 16;             // its m16 tiles of S^T
constexpr int kMaxSmem = 232448;
static_assert(2 * 32 == D, "a decay lane per two channels");
static_assert(2 * NSUB == THREADS / 32, "two decay and score warps a sub-chunk");

// shared memory, in bytes
constexpr int STAGE_BF = CHUNK * BSTR * 2;           // r, k or v of a chunk
constexpr int STAGE_W = CHUNK * D * 4;               // w of a chunk
constexpr int STAGE = 3 * STAGE_BF + STAGE_W;
constexpr int ROWS = CHUNK * FSTR * 4;               // 64 float rows
constexpr int OFF_RT = STAGES * STAGE;               // r * E, TF32
constexpr int OFF_KT = OFF_RT + ROWS;                // k * F, TF32
constexpr int OFF_X = OFF_KT + ROWS;                 // score queries, TF32
constexpr int OFF_Y = OFF_X + ROWS;                  // score keys, TF32
constexpr int OFF_A = OFF_Y + NSUB * NY * FSTR * 4;  // scores, TF32
constexpr int OFF_E = OFF_A + NSUB * SUB * ASTR * 4; // E of each sub-chunk
constexpr int SMEM = OFF_E + NSUB * D * 4;
static_assert(SMEM <= kMaxSmem, "shared memory of a block");

__global__ void __launch_bounds__(THREADS, 1)
rwkv6_chunked_kernel(const __nv_bfloat16* __restrict__ r,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ w,
                     const float* __restrict__ u,
                     float* __restrict__ state,
                     __nv_bfloat16* __restrict__ out, int L, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rt = reinterpret_cast<float*>(smem + OFF_RT);
  float* kt = reinterpret_cast<float*>(smem + OFF_KT);
  float* xs = reinterpret_cast<float*>(smem + OFF_X);
  float* ys = reinterpret_cast<float*>(smem + OFF_Y);
  float* as = reinterpret_cast<float*>(smem + OFF_A);
  float* es = reinterpret_cast<float*>(smem + OFF_E);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int64_t row = (int64_t)H * D;                 // token stride
  const int64_t base = (int64_t)b * L * row + (int64_t)h * D;
  const int nchunks = (L + CHUNK - 1) / CHUNK;

  // stage the chunk c into ring slot c % STAGES (one commit group)
  auto stage_chunk = [&](int c) {
    if (c < nchunks) {
      unsigned char* slot = smem + (c % STAGES) * STAGE;
      const int t0 = c * CHUNK;
      for (int p = tid; p < 3 * CHUNK * 8 + CHUNK * 16; p += THREADS) {
        if (p < 3 * CHUNK * 8) {
          const int which = p / (CHUNK * 8), rem = p % (CHUNK * 8);
          const int tr = rem >> 3, piece = rem & 7;
          const __nv_bfloat16* src = which == 0 ? r : which == 1 ? k : v;
          const bool ok = t0 + tr < L;
          const __nv_bfloat16* g =
              ok ? src + base + (int64_t)(t0 + tr) * row + piece * 8 : src;
          cp_async16(slot + which * STAGE_BF + (tr * BSTR + piece * 8) * 2,
                     g, ok ? 16 : 0);
        } else {
          const int rem = p - 3 * CHUNK * 8, tr = rem >> 4, piece = rem & 15;
          const bool ok = t0 + tr < L;
          const float* g =
              ok ? w + base + (int64_t)(t0 + tr) * row + piece * 4 : w;
          cp_async16(slot + 3 * STAGE_BF + (tr * D + piece * 4) * 4, g,
                     ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // a product warp's state tile, S^T[j][i] for j in [j0, j0 + VT) and all
  // 64 channels: st[mt][nt] is the accumulator of rows j0 + 16 mt + [0,
  // 16) and channels 8 nt + [0, 8)
  const int j0 = warp * VT;
  float* sbh = state + (int64_t)bh * D * D;
  float st[MT][D / 8][4];
  if (warp < PW) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[mt][nt][e] = sbh[(8 * nt + 2 * tg + (e & 1)) * D + j0 +
                              16 * mt + gq + 8 * (e >> 1)];
  }
  for (int n = tid; n < NSUB * SUB * ASTR; n += THREADS) as[n] = 0.f;
  float u8[8];                          // u of the score lane's channels
#pragma unroll
  for (int i = 0; i < 8; ++i) u8[i] = u[h * D + 8 * (lane & 7) + i];

  stage_chunk(0);
  stage_chunk(1);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();            // chunk c landed; chunk c - 1 fully used
    stage_chunk(c + STAGES - 1);
    const unsigned char* st_c = smem + (c % STAGES) * STAGE;
    const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(st_c);
    const __nv_bfloat16* ks =
        reinterpret_cast<const __nv_bfloat16*>(st_c + STAGE_BF);
    const __nv_bfloat16* vs =
        reinterpret_cast<const __nv_bfloat16*>(st_c + 2 * STAGE_BF);
    const float* ws = reinterpret_cast<const float*>(st_c + 3 * STAGE_BF);
    const int t0 = c * CHUNK;

    // 1. decays: warp q walks sub-chunk q forward, warp 4 + q backward,
    // lane l channels 2l, 2l + 1.  Forward: E_s (from the sub-chunk's
    // start) for r * E and the prefix within the score block for X.
    // Backward: F_t (to the sub-chunk's end) for k * F, the suffix within
    // the score block, each block's product W, and Y's key rows: k_t
    // prod_{t<j<4a} w_j for each query block a past t's block b, the
    // blocks between multiplied in order.
    {
      const int q = warp % NSUB, r0 = q * SUB, c2 = 2 * lane;
      auto w_row = [&](int tr) {
        return t0 + tr < L ? *reinterpret_cast<const float2*>(ws + tr * D + c2)
                           : make_float2(1.f, 1.f);
      };
      auto bf_row = [&](const __nv_bfloat16* x, int tr) {
        return __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + tr * BSTR + c2));
      };
      auto put = [&](float* x, float a, float b) {
        *reinterpret_cast<float2*>(x) = make_float2(tf32(a), tf32(b));
      };
      if (warp < NSUB) {
        float2 e = make_float2(1.f, 1.f), e4 = e;
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          const int tr = r0 + s;
          const float2 wv = w_row(tr), rv = bf_row(rs, tr);
          if (s % BLK == 0) e4 = make_float2(1.f, 1.f);
          put(rt + tr * FSTR + c2, rv.x * e.x, rv.y * e.y);
          put(xs + tr * FSTR + c2, rv.x * e4.x, rv.y * e4.y);
          e.x *= wv.x; e.y *= wv.y;
          e4.x *= wv.x; e4.y *= wv.y;
        }
        *reinterpret_cast<float2*>(es + q * D + c2) = e;
      } else {
        float* yq = ys + q * NY * FSTR + c2;
        float2 f = make_float2(1.f, 1.f), f4 = f, pb = f, wb[SUB / BLK];
#pragma unroll
        for (int s = SUB - 1; s >= 0; --s) {
          const int tr = r0 + s, blk = s / BLK;
          const float2 wv = w_row(tr), kv = bf_row(ks, tr);
          if (s % BLK == BLK - 1) f4 = pb = make_float2(1.f, 1.f);
          put(kt + tr * FSTR + c2, kv.x * f.x, kv.y * f.y);
          float2 y = make_float2(kv.x * f4.x, kv.y * f4.y);
#pragma unroll
          for (int qa = blk + 1; qa < SUB / BLK; ++qa) {
            if (qa > blk + 1) { y.x *= wb[qa - 1].x; y.y *= wb[qa - 1].y; }
            put(yq + (y_row(qa) + s) * FSTR, y.x, y.y);
          }
          f.x *= wv.x; f.y *= wv.y;
          f4.x *= wv.x; f4.y *= wv.y;
          pb.x *= wv.x; pb.y *= wv.y;
          if (s % BLK == 0) wb[blk] = pb;
        }
      }
    }
    __syncthreads();

    // 2. scores: warp q < 4 the pairs across score blocks of sub-chunk q
    // (tensor cores), warp 4 + q those within them and the bonus terms
    // (rows past L hold r = k = 0)
    if (warp < NSUB)
      scores_across(xs + warp * SUB * FSTR, ys + warp * NY * FSTR,
                    as + warp * SUB * ASTR, lane);
    else {
      const int q = warp - NSUB;
      scores_within(rs + q * SUB * BSTR, ks + q * SUB * BSTR, ws + q * SUB * D,
                    u8, as + q * SUB * ASTR, lane);
    }
    __syncthreads();

    // 3. product warps: per sub-chunk, out = (r * E) . S + A v, then
    // S^T <- S^T diag(E) + v^T (k * F)
    if (warp < PW) {
      const int nq = min(NSUB, (L - t0 + SUB - 1) / SUB);
#pragma unroll 1
      for (int q = 0; q < nq; ++q) {
        const int r0 = q * SUB;
        // v rows r0 + 8 tk + tg + 4 hf, columns j0 + 8 cc + gq
        float vf[2][2][2 * MT];
#pragma unroll
        for (int tk = 0; tk < 2; ++tk)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int cc = 0; cc < 2 * MT; ++cc)
              vf[tk][hf][cc] =
                  bf(vs[(r0 + 8 * tk + tg + 4 * hf) * BSTR + j0 + 8 * cc + gq]);
        // (r * E) . S with S = hi + lo: hi in TF32 (m16n8k8), lo (2^-11
        // of S) in bf16 with r * E in bf16 (m16n8k16, two 8-channel steps
        // a product), then A v
        float oa[2 * MT][4] = {}, ob[2 * MT][4] = {};
#pragma unroll
        for (int k2 = 0; k2 < D / 16; ++k2) {
          float2 rl[2], rh[2];            // rows gq, gq + 8; 2 channels
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int ch = 8 * (2 * k2 + m) + 2 * tg;
            rl[m] = *reinterpret_cast<const float2*>(rt + (r0 + gq) * FSTR + ch);
            rh[m] = *reinterpret_cast<const float2*>(
                rt + (r0 + gq + 8) * FSTR + ch);
          }
          const uint32_t a0 = pack_bf16(rl[0].x, rl[0].y);
          const uint32_t a1 = pack_bf16(rh[0].x, rh[0].y);
          const uint32_t a2 = pack_bf16(rl[1].x, rl[1].y);
          const uint32_t a3 = pack_bf16(rh[1].x, rh[1].y);
#pragma unroll
          for (int jn = 0; jn < 2 * MT; ++jn) {
            uint32_t lo[2];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float s0 = st[jn >> 1][2 * k2 + m][2 * (jn & 1)];
              const float s1 = st[jn >> 1][2 * k2 + m][2 * (jn & 1) + 1];
              const float h0 = tf32(s0), h1 = tf32(s1);
              mma_tf32(oa[jn], rl[m].x, rh[m].x, rl[m].y, rh[m].y, h0, h1);
              lo[m] = pack_bf16(s0 - h0, s1 - h1);
            }
            mma_bf16(ob[jn], a0, a1, a2, a3, lo[0], lo[1]);
          }
        }
        const float* aq = as + q * SUB * ASTR;
#pragma unroll
        for (int tk = 0; tk < 2; ++tk) {
          const float* a0 = aq + gq * ASTR + 8 * tk + tg;
          const float* a1 = a0 + 8 * ASTR;
#pragma unroll
          for (int jn = 0; jn < 2 * MT; ++jn)
            mma_tf32(ob[jn], a0[0], a1[0], a0[4], a1[4], vf[tk][0][jn],
                     vf[tk][1][jn]);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int tr = r0 + gq + 8 * hf;
          if (t0 + tr < L) {
            __nv_bfloat16* o = out + base + (int64_t)(t0 + tr) * row + j0 +
                               2 * tg;
#pragma unroll
            for (int jn = 0; jn < 2 * MT; ++jn)
              *reinterpret_cast<__nv_bfloat162*>(o + 8 * jn) =
                  __floats2bfloat162_rn(oa[jn][2 * hf] + ob[jn][2 * hf],
                                        oa[jn][2 * hf + 1] +
                                            ob[jn][2 * hf + 1]);
          }
        }
        // the state step
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const float2 e =
              *reinterpret_cast<const float2*>(es + q * D + 8 * nt + 2 * tg);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            st[mt][nt][0] *= e.x;
            st[mt][nt][1] *= e.y;
            st[mt][nt][2] *= e.x;
            st[mt][nt][3] *= e.y;
          }
        }
#pragma unroll
        for (int tk = 0; tk < 2; ++tk) {
          const float* k0 = kt + (r0 + 8 * tk + tg) * FSTR + gq;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt) {
            const float b0 = k0[8 * nt], b1 = k0[8 * nt + 4 * FSTR];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_tf32(st[mt][nt], vf[tk][0][2 * mt], vf[tk][0][2 * mt + 1],
                       vf[tk][1][2 * mt], vf[tk][1][2 * mt + 1], b0, b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (warp < PW) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sbh[(8 * nt + 2 * tg + (e & 1)) * D + j0 + 16 * mt + gq +
              8 * (e >> 1)] = st[mt][nt][e];
  }
}

}  // namespace

// The plan's fields (kernels/rwkv6_scan.py :: plan): the grid, B * H
// blocks of `threads` threads with `smem` dynamic shared bytes; each must
// be this file's.  r, k, v, out (bf16), w and u 16-byte aligned; d 64.
extern "C" int rwkv6_chunked_launch(const void* r, const void* k,
                                    const void* v, const float* w,
                                    const float* u, float* state, void* out,
                                    int b, int L, int h, int d, int grid,
                                    int threads, int smem, void* stream) {
  if (b <= 0 || L <= 0 || h <= 0 || d != D || (int64_t)b * h != grid ||
      threads != THREADS || smem != SMEM ||
      (int64_t)b * L * h * D > 0x7FFFFFFFLL ||
      ((uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)w |
       (uintptr_t)u | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  rwkv6_chunked_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)r, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, w, u, state, (__nv_bfloat16*)out, L, h);
  return (int)cudaGetLastError();
}
