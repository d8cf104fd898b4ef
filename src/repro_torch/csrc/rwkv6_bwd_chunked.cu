// Gradient of the RWKV-6 (Finch) WKV recurrence from a zero state in
// sub-chunks on the tensor cores: the bf16 route of the WKV backward on
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its jnp
//   `_wkv_chunked` (src/repro/models/rwkv.py) with jax.grad and has no
//   Pallas backward.  Like csrc/rwkv6_bwd.cu (the `recurrent` route), it is
//   the port's own gradient of the function of
//   src/repro/kernels/rwkv6_scan.py:64, and computes exactly that file's
//   function (its header): (dr, dk, dv, dw, du) of out = WKV(r, k, v, w, u)
//   from a zero state given do, dr, dk, dv rounded once to bf16, dw and du
//   float32, every sum in float32, no atomics (two launches give the same
//   bits).  kernels/rwkv6_bwd.py :: route sends it the bf16 calls at D 64
//   from L = CHUNKED_MIN_LEN: every call of the rwkv6-3b training step.
//
// The form (kernels/ref.py :: wkv_bwd_subchunk_ref is it in plain PyTorch,
//   step for step).  Per (b, h) and sub-chunk of SUB = 16 tokens, with S
//   the state at its start, G the gradient of the state after it, E_s =
//   prod_{j<s} w_j, F_t = prod_{t<j<16} w_j, E = prod_j w_j, P(t, s) =
//   prod_{t<j<s} w_j, A the forward's scores and dA[s, t] = do_s . v_t:
//     dr_s = E_s * (S do_s) + sum_{t<s} dA[s,t] k_t * P(t,s) + dA[s,s] u k_s
//     dk_t = F_t * (G v_t) + sum_{s>t} dA[s,t] r_s * P(t,s) + dA[t,t] u r_t
//     dv_t = (k_t * F_t)^T G + sum_{s>=t} A[s,t] do_s
//     dw_t = rowsum(dS_t+1 * S_t) = E_t F_t rowsum(G * S) + F_t q_t
//            + E_t p_t + sum_{s>t} r_s * P(t,s) * Z[s,t]
//     q_t+1 = w_t q_t + k_t * (G v_t),  p_t-1 = w_t p_t + r_t * (S do_t),
//     Z[s,t+1] = w_t Z[s,t] + dA[s,t] k_t
//   No decay is divided by another: every factor is a running product of
//   w's <= 1, so at w near 1e-6 the decays underflow where the true ones
//   do and only the direct terms remain (csrc/rwkv6_bwd.cu says why the
//   dlog w identity cannot be used).  Padding past L is r = k = v = do = 0
//   and w = 1: no contribution, no decay.
//
// Bound on the H100 at the rwkv6-3b training shape (B 2, L 2048, H 40,
//   D 64, bf16): the function moves 231 MB (r, k, v, do, dr, dk, dv bf16,
//   w, dw float32), 68.9 us at 3.35 TB/s; its 14 D^2 operations a (token,
//   head) are 9.4 GFLOP, 140 us on the CUDA cores at 67 TFLOP/s, but 19 us
//   at the TF32 rate, where this route puts them: bytes bound it (68.9 us).
//   This design moves 368 MB (the inputs twice, 84 MB of states written
//   and read once), its floor 110 us.
//
// Design: three launches, so that most of the work runs in parallel over
//   64-token chunks instead of in order over L.
//   1. rwkv6_bwd_states_kernel, 2 B H blocks of 8 warps (160 at the
//      training shape, two a SM by 89 KB of shared memory).  Block (dir,
//      b, h) walks its sequence in CHUNK = 64 tokens, forwards for the
//      state S (dir 0: S <- diag(E) S + sum_t (k_t * F_t) v_t^T, F to the
//      chunk's end) or backwards for its gradient G (dir 1: G <- diag(E)
//      G + sum_s (r_s * E_s) do_s^T, E from the chunk's start), and writes
//      the state before each chunk (S) or after it (G) to a float32
//      scratch, (2, B H, ceil(L / 64), D, D), 84 MB at the training shape.
//      Four warps hold a 16-row tile of the state each in mma
//      accumulators, one chunk a K = 64 product (64 mma); every thread
//      makes the decays of one channel over a run of 16 tokens, then
//      scales them by the other runs' products; the next chunk's rows are
//      staged by cp.async while this one is used.
//   2. rwkv6_bwd_chunk_kernel, one block of 8 warps for each (b, h,
//      chunk), 2560 blocks, 226 KB of shared memory (one a SM).  It
//      stages the chunk's r, k, v, do (bf16), w, S and G by cp.async, steps
//      G backwards through the chunk's 4 sub-chunks (every G kept), then
//      walks the sub-chunks forwards, three barriers a sub-chunk:
//      A. the decays (warps 0-3, a thread a channel: X, Xt, k F and Y),
//         dA = do v^T on the tensor cores (warp 4, bf16 operands, exact
//         products), the scores within blocks (warp 5), rowsum(G * S)
//         (warps 6-7);
//      B. the products: S do and dr's across-block sum (warps 0-1), G v
//         and dk's (warps 2-3), dv = (k F)^T G + A^T do (warps 4-5, the
//         second once warp 6 has the scores across blocks), and the state
//         step into the other of two S buffers (warps 6-7);
//      C. a thread a channel, the sub-chunk's w, k, r in registers and F
//         made again from w: dw (warps 0-3, two threads a channel: the four
//         terms, Z's O(16^2) recurrence split between them), dr and dk
//         (warps 4-7: the products' parts, the pairs inside a block of 4,
//         the bonus).
//      The pairs across blocks of 4 are factored at the block boundary as
//      the forward factors its scores: dr_s's at the query's block start g
//      (Xd_s = prod_{g<=j<s} w_j times the product of dA with the
//      forward's Y), dk_t's at the end e of the key's block (Sf_t =
//      prod_{t<j<e} w_j times the product of dA with Xt_s = r_s
//      prod_{e<=j<s} w_j): 16 x 64 x 24 products, no quotient.
//   3. rwkv6_bwd_chunked_du_kernel: du = the per-chunk partial sums, over
//      the chunks and then b, in order.
//   Products are mma.sync m16n8k8 TF32 with float32 accumulators (the
//   forward's helpers, csrc/wkv_subchunk.cuh): every tile here is a warp's
//   16 rows, which wgmma's 64-row warpgroup tiles would not fit without
//   regrouping the stages.  Operands: r * E, k * F, X, Y, Xt, A and dA in
//   the across-block sums TF32; v and do bf16 (exact in TF32; dA = do v^T
//   takes them as bf16 in m16n8k16); S and G as hi = TF32(S) and lo =
//   TF32(S - hi) in two mmas (a single TF32 rounding of the forward's S
//   read 9.0e-3 of a row at w near 1e-6 on the H100).  The decays, the
//   pairs inside a block, dw's recurrences and rowsum(G * S) are float32
//   on the CUDA cores.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 12 and
//   phase 25's profile; launch/wkv_bwd_stages.py): 566-576 us at the
//   training shape, the states ~112 us and the chunk blocks ~453 us a
//   call; a chunk block ~41k cycles, of which the staging ~5.8k and a
//   sub-chunk's stages A, B, C ~1.5k, ~3k and ~3.5k.  An L2 prefetch of
//   the block a wave ahead, issued after its first sub-chunk, made the
//   chunk blocks slower (465 against 454 us), so there is none.
#include "wkv_subchunk.cuh"

namespace {

constexpr int CHUNK = 64;               // tokens between stored states
constexpr int NSUB = CHUNK / SUB;       // sub-chunks a chunk
constexpr int THREADS = 256;            // 8 warps, every kernel but du
constexpr int DYSTR = NY + 4;           // float row stride of DY, DX
constexpr int kMaxSmem = 232448;

// Xt's first row for key block b (0..2): rows s = 4 (b + 1) .. 15 follow.
__host__ __device__ constexpr int xt_row(int b) {
  return b == 0 ? 0 : b == 1 ? 12 : 20;
}

// ---- launch 1: the states at chunk boundaries ----
constexpr int ST_BF = CHUNK * BSTR * 2;                  // a bf16 operand
constexpr int ST_W = CHUNK * D * 4;                      // w of a chunk
constexpr int ST_STAGE = 2 * ST_BF + ST_W;
constexpr int ST_OFF_AF = 2 * ST_STAGE;                  // (x * decay), TF32
constexpr int ST_OFF_E = ST_OFF_AF + CHUNK * FSTR * 4;   // chunk's decay
constexpr int ST_OFF_RUN = ST_OFF_E + D * 4;             // each run's decay
constexpr int RUN = CHUNK / 4;                           // tokens a run
constexpr int ST_SMEM = ST_OFF_RUN + (CHUNK / RUN) * D * 4;
static_assert(ST_SMEM * 2 <= 228 * 1024, "two state blocks a SM");

// Stage chunk c's rows of x (bf16), y (bf16) and w (rows past L: x = y =
// 0, w = 1) into `slot`, one cp.async group.
__device__ __forceinline__ void stage_rows(unsigned char* slot,
                                           const __nv_bfloat16* x,
                                           const __nv_bfloat16* y,
                                           const float* w, int64_t base,
                                           int64_t row, int t0, int L,
                                           int tid) {
  for (int p = tid; p < 2 * CHUNK * 8 + CHUNK * 16; p += THREADS) {
    if (p < 2 * CHUNK * 8) {
      const int which = p / (CHUNK * 8), rem = p % (CHUNK * 8);
      const int tr = rem >> 3, piece = rem & 7;
      const __nv_bfloat16* src = which == 0 ? x : y;
      const bool ok = t0 + tr < L;
      cp_async16(slot + which * ST_BF + (tr * BSTR + piece * 8) * 2,
                 ok ? src + base + (int64_t)(t0 + tr) * row + piece * 8 : src,
                 ok ? 16 : 0);
    } else {
      const int rem = p - 2 * CHUNK * 8, tr = rem >> 4, piece = rem & 15;
      float* dst = reinterpret_cast<float*>(slot + 2 * ST_BF) + tr * D +
                   piece * 4;
      if (t0 + tr < L)
        cp_async16(dst, w + base + (int64_t)(t0 + tr) * row + piece * 4, 16);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(1.f, 1.f, 1.f, 1.f);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 2)
rwkv6_bwd_states_kernel(const __nv_bfloat16* __restrict__ r,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ w,
                        float* __restrict__ scratch, int B, int L, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* af = reinterpret_cast<float*>(smem + ST_OFF_AF);
  float* etot = reinterpret_cast<float*>(smem + ST_OFF_E);
  float* runs = reinterpret_cast<float*>(smem + ST_OFF_RUN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int bhn = B * H;
  const int dir = blockIdx.x / bhn, bh = blockIdx.x % bhn;
  const int h = bh % H, b = bh / H;
  const int64_t row = (int64_t)H * D;
  const int64_t base = (int64_t)b * L * row + (int64_t)h * D;
  const int nc = (L + CHUNK - 1) / CHUNK;
  // dir 0: S from k, v walking forwards; dir 1: G from r, do backwards
  const __nv_bfloat16* x = dir == 0 ? k : r;
  const __nv_bfloat16* y = dir == 0 ? v : dout;
  float* out = scratch + ((int64_t)dir * bhn + bh) * nc * D * D;
  auto chunk_of = [&](int idx) { return dir == 0 ? idx : nc - 1 - idx; };

  // warp < 4: rows [16 warp, +16) of the state, all D columns
  const int i0 = 16 * warp;
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  stage_rows(smem, x, y, w, base, row, chunk_of(0) * CHUNK, L, tid);
  for (int idx = 0; idx < nc; ++idx) {
    const int c = chunk_of(idx);
    cp_async_wait<0>();
    __syncthreads();            // chunk idx landed; chunk idx - 1 fully used
    if (idx + 1 < nc)
      stage_rows(smem + ((idx + 1) & 1) * ST_STAGE, x, y, w, base, row,
                 chunk_of(idx + 1) * CHUNK, L, tid);
    const unsigned char* slot = smem + (idx & 1) * ST_STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(slot);
    const __nv_bfloat16* ys =
        reinterpret_cast<const __nv_bfloat16*>(slot + ST_BF);
    const float* ws = reinterpret_cast<const float*>(slot + 2 * ST_BF);
    if (warp < 4) {             // the state before chunk c (S) or after (G)
      float* o = out + (int64_t)c * D * D;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(o + (i0 + gq + 8 * hf) * D + 8 * nt +
                                     2 * tg) =
              make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
    if (idx + 1 == nc) break;   // no later state needs this chunk
    // the decays, a thread a (channel, run of 16 tokens): F to the chunk's
    // end (dir 0) or E from its start (dir 1) inside the run, then times
    // the runs after it (before it)
    {
      const int i = tid & (D - 1), run = tid >> 6, t0r = run * RUN;
      float dec[RUN], prod = 1.f;
      if (dir == 0) {
#pragma unroll
        for (int m = RUN - 1; m >= 0; --m) {
          dec[m] = prod;
          prod *= ws[(t0r + m) * D + i];
        }
      } else {
#pragma unroll
        for (int m = 0; m < RUN; ++m) {
          dec[m] = prod;
          prod *= ws[(t0r + m) * D + i];
        }
      }
      runs[run * D + i] = prod;
      __syncthreads();
      float scale = 1.f;
      if (dir == 0) {
        for (int o = CHUNK / RUN - 1; o > run; --o) scale *= runs[o * D + i];
      } else {
        for (int o = 0; o < run; ++o) scale *= runs[o * D + i];
      }
#pragma unroll
      for (int m = 0; m < RUN; ++m)
        af[(t0r + m) * FSTR + i] =
            tf32(bf(xs[(t0r + m) * BSTR + i]) * (dec[m] * scale));
      if (run == 0) {                   // the chunk's decay, runs in order
        float e = 1.f;
        if (dir == 0) {
          for (int o = CHUNK / RUN - 1; o >= 0; --o) e *= runs[o * D + i];
        } else {
          for (int o = 0; o < CHUNK / RUN; ++o) e *= runs[o * D + i];
        }
        etot[i] = e;
      }
    }
    __syncthreads();
    if (warp < 4) {             // state <- diag(E) state + af^T y
      const float e0 = etot[i0 + gq], e1 = etot[i0 + gq + 8];
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
#pragma unroll
      for (int ks = 0; ks < CHUNK / 8; ++ks) {
        const float* a0 = af + (8 * ks + tg) * FSTR + i0 + gq;
        const float* a1 = a0 + 4 * FSTR;
        const __nv_bfloat16* b0 = ys + (8 * ks + tg) * BSTR + gq;
        const __nv_bfloat16* b1 = b0 + 4 * BSTR;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          mma_tf32(acc[nt], a0[0], a0[8], a1[0], a1[8], bf(b0[8 * nt]),
                   bf(b1[8 * nt]));
      }
    }
  }
}

// ---- launch 2: the gradients, a block a (b, h, chunk) ----
constexpr int ROWSF = CHUNK * FSTR * 4;                  // 64 float rows
constexpr int SUBR = SUB * FSTR * 4;                     // 16 float rows
constexpr int OFF_R = 0;                                 // bf16 rows
constexpr int OFF_K = OFF_R + CHUNK * BSTR * 2;
constexpr int OFF_V = OFF_K + CHUNK * BSTR * 2;
constexpr int OFF_DO = OFF_V + CHUNK * BSTR * 2;
constexpr int OFF_W = OFF_DO + CHUNK * BSTR * 2;         // w, stride D
constexpr int OFF_E = OFF_W + CHUNK * D * 4;             // E_s
constexpr int OFF_EQ = OFF_E + ROWSF;                    // E of each sub
constexpr int OFF_G = OFF_EQ + NSUB * D * 4;             // G of each sub
constexpr int OFF_S = OFF_G + NSUB * D * FSTR * 4;       // S, two buffers
constexpr int OFF_X = OFF_S + 2 * D * FSTR * 4;          // this sub-chunk:
constexpr int OFF_XT = OFF_X + SUBR;                     //   X, then dw's
constexpr int OFF_KF = OFF_XT + NY * FSTR * 4;           //   2nd half; Xt,
constexpr int OFF_Y = OFF_KF + SUBR;                     //   k * F and Y
constexpr int OFF_DA = OFF_Y + NY * FSTR * 4;            //   (TF32), dA,
constexpr int OFF_A = OFF_DA + SUB * ASTR * 4;           //   A (TF32), dA
constexpr int OFF_DY = OFF_A + SUB * ASTR * 4;           //   by Y row and
constexpr int OFF_DX = OFF_DY + SUB * DYSTR * 4;         //   by Xt row
constexpr int OFF_SD = OFF_DX + SUB * DYSTR * 4;         //   S do_t
constexpr int OFF_GV = OFF_SD + SUBR;                    //   G v_t
constexpr int OFF_DRX = OFF_GV + SUBR;                   //   dr, dk across
constexpr int OFF_DKX = OFF_DRX + SUBR;                  //   blocks
constexpr int OFF_RS = OFF_DKX + SUBR;                   //   rowsum(G * S)
constexpr int OFF_U = OFF_RS + D * 4;                    // u
constexpr int SMEM = OFF_U + D * 4;
static_assert(SMEM <= kMaxSmem, "shared memory of a block");

// dw's Z sum over the queries s of `mask` (bit s), added into acc: for
// each s, Z walks t < s forwards, r_s P(t, s) backwards.
template <unsigned MASK>
__device__ __forceinline__ void dw_z(const float* wv, const float* kv,
                                     const float* rv, const float* da,
                                     float* acc) {
#pragma unroll
  for (int s = 1; s < SUB; ++s) {
    if (!((MASK >> s) & 1u)) continue;
    float zs[SUB];
    float z = 0.f;
#pragma unroll
    for (int t = 0; t < s; ++t) {
      zs[t] = z;
      z = fmaf(wv[t], z, da[s * ASTR + t] * kv[t]);
    }
    float y = rv[s];
#pragma unroll
    for (int t = s - 1; t >= 0; --t) {
      acc[t] = fmaf(y, zs[t], acc[t]);
      y *= wv[t];
    }
  }
}

// Queries of dw's Z sum for each of the two threads of a channel: 60 of
// the 120 (s, t) pairs each.
constexpr unsigned kZ0 = (1u << 15) | (1u << 14) | (1u << 13) | (1u << 12) |
                         (1u << 6);
constexpr unsigned kZ1 = 0xFFFEu & ~kZ0;

__global__ void __launch_bounds__(THREADS, 1)
rwkv6_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ r,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ w,
                       const float* __restrict__ u,
                       const float* __restrict__ scratch,
                       __nv_bfloat16* __restrict__ dr,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       float* __restrict__ dw, float* __restrict__ du_part,
                       int B, int L, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(smem + OFF_R);
  const __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + OFF_K);
  const __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + OFF_V);
  const __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem + OFF_DO);
  float* ws = reinterpret_cast<float*>(smem + OFF_W);
  float* es = reinterpret_cast<float*>(smem + OFF_E);
  float* eq = reinterpret_cast<float*>(smem + OFF_EQ);
  float* gs = reinterpret_cast<float*>(smem + OFF_G);
  float* ss = reinterpret_cast<float*>(smem + OFF_S);
  float* xq = reinterpret_cast<float*>(smem + OFF_X);
  float* dwp = xq;                      // X is dead once the scores are
  float* xt = reinterpret_cast<float*>(smem + OFF_XT);
  float* kf = reinterpret_cast<float*>(smem + OFF_KF);
  float* ys = reinterpret_cast<float*>(smem + OFF_Y);
  float* das = reinterpret_cast<float*>(smem + OFF_DA);
  float* as = reinterpret_cast<float*>(smem + OFF_A);
  float* dys = reinterpret_cast<float*>(smem + OFF_DY);
  float* dxs = reinterpret_cast<float*>(smem + OFF_DX);
  float* sds = reinterpret_cast<float*>(smem + OFF_SD);
  float* gvs = reinterpret_cast<float*>(smem + OFF_GV);
  float* drx = reinterpret_cast<float*>(smem + OFF_DRX);
  float* dkx = reinterpret_cast<float*>(smem + OFF_DKX);
  float* rsum = reinterpret_cast<float*>(smem + OFF_RS);
  float* us = reinterpret_cast<float*>(smem + OFF_U);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int nc = (L + CHUNK - 1) / CHUNK;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int h = bh % H, b = bh / H;
  const int64_t row = (int64_t)H * D;
  const int64_t base = (int64_t)b * L * row + (int64_t)h * D;
  const int t0 = c * CHUNK;
  const int nq = (min(CHUNK, L - t0) + SUB - 1) / SUB;   // sub-chunks in L
  const float* s_in = scratch + ((int64_t)bh * nc + c) * D * D;
  const float* g_in = s_in + (int64_t)B * H * nc * D * D;

  // stage r, k, v, do, w (rows past L: zeros, w = 1), S and G
  for (int p = tid; p < 4 * CHUNK * 8 + CHUNK * 16 + 2 * D * 16;
       p += THREADS) {
    if (p < 4 * CHUNK * 8) {
      const int which = p / (CHUNK * 8), rem = p % (CHUNK * 8);
      const int tr = rem >> 3, piece = rem & 7;
      const __nv_bfloat16* src =
          which == 0 ? r : which == 1 ? k : which == 2 ? v : dout;
      const bool ok = t0 + tr < L;
      cp_async16(smem + which * CHUNK * BSTR * 2 + (tr * BSTR + piece * 8) * 2,
                 ok ? src + base + (int64_t)(t0 + tr) * row + piece * 8 : src,
                 ok ? 16 : 0);
    } else if (p < 4 * CHUNK * 8 + CHUNK * 16) {
      const int rem = p - 4 * CHUNK * 8, tr = rem >> 4, piece = rem & 15;
      float* dst = ws + tr * D + piece * 4;
      if (t0 + tr < L)
        cp_async16(dst, w + base + (int64_t)(t0 + tr) * row + piece * 4, 16);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(1.f, 1.f, 1.f, 1.f);
    } else {
      const int rem = p - 4 * CHUNK * 8 - CHUNK * 16;
      const int which = rem / (D * 16), i = (rem >> 4) % D, piece = rem & 15;
      cp_async16((which == 0 ? ss : gs + (NSUB - 1) * D * FSTR) + i * FSTR +
                     piece * 4,
                 (which == 0 ? s_in : g_in) + i * D + piece * 4, 16);
    }
  }
  cp_async_commit();
  for (int n = tid; n < SUB * ASTR; n += THREADS) as[n] = 0.f;
  for (int n = tid; n < SUB * DYSTR; n += THREADS) dys[n] = dxs[n] = 0.f;
  if (tid < D) us[tid] = u[h * D + tid];
  cp_async_wait<0>();
  __syncthreads();

  // E_s from each sub-chunk's start and each sub-chunk's E, a thread a
  // (channel, sub-chunk)
  {
    const int i = tid & (D - 1), q = tid >> 6;
    float e = 1.f;
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      es[(q * SUB + s) * FSTR + i] = e;
      e *= ws[(q * SUB + s) * D + i];
    }
    eq[q * D + i] = e;
  }
  __syncthreads();

  // G backwards through the sub-chunks: G_q-1 = diag(E_q) G_q + sum_s
  // (r_s * E_s) do_s^T; warp: rows [16 (warp / 2), +16), columns [32
  // (warp % 2), +32)
  {
    const int i0 = 16 * (warp >> 1), j0 = 32 * (warp & 1);
    float acc[4][4];
    const float* g3 = gs + (NSUB - 1) * D * FSTR;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] = g3[(i0 + gq + 8 * (e >> 1)) * FSTR + j0 + 8 * nt +
                        2 * tg + (e & 1)];
    for (int q = NSUB - 1; q >= 1; --q) {
      const float e0 = eq[q * D + i0 + gq], e1 = eq[q * D + i0 + gq + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int sa = q * SUB + 8 * kk + tg, sb = sa + 4;
        const int ia = i0 + gq;
        const float a0 = tf32(bf(rs[sa * BSTR + ia]) * es[sa * FSTR + ia]);
        const float a1 =
            tf32(bf(rs[sa * BSTR + ia + 8]) * es[sa * FSTR + ia + 8]);
        const float a2 = tf32(bf(rs[sb * BSTR + ia]) * es[sb * FSTR + ia]);
        const float a3 =
            tf32(bf(rs[sb * BSTR + ia + 8]) * es[sb * FSTR + ia + 8]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32(acc[nt], a0, a1, a2, a3,
                   bf(os[sa * BSTR + j0 + 8 * nt + gq]),
                   bf(os[sb * BSTR + j0 + 8 * nt + gq]));
      }
      float* gout = gs + (q - 1) * D * FSTR;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(gout + (i0 + gq + 8 * hf) * FSTR + j0 +
                                     8 * nt + 2 * tg) =
              make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  }
  __syncthreads();

  float du_acc = 0.f;                   // channel tid, in token order
  for (int q = 0; q < nq; ++q) {
    const int r0 = q * SUB;
    const float* gq_ = gs + q * D * FSTR;
    const float* s_now = ss + (q & 1) * D * FSTR;

    // ---- A: decays, dA, scores within blocks, rowsum(G * S) ----
    if (warp < 2) {
      // forwards, channel i: X = r Xd (Xd the block prefix), Xt rows
      const int i = tid;
      float e4 = 1.f, wb[SUB / BLK - 1];
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        const float wv = ws[(r0 + s) * D + i];
        const float rv = bf(rs[(r0 + s) * BSTR + i]);
        if (s % BLK == 0) e4 = 1.f;
        xq[s * FSTR + i] = tf32(rv * e4);
        float x = rv * e4;
#pragma unroll
        for (int kb = s / BLK - 1; kb >= 0; --kb) {
          if (kb < s / BLK - 1) x *= wb[kb + 1];
          xt[(xt_row(kb) + s - BLK * (kb + 1)) * FSTR + i] = tf32(x);
        }
        e4 *= wv;
        if (s % BLK == BLK - 1 && s / BLK < SUB / BLK - 1)
          wb[s / BLK] = e4;
      }
    } else if (warp < 4) {
      // backwards, channel i: k F, Y rows
      const int i = tid - 64;
      float f = 1.f, f4 = 1.f, wb[SUB / BLK];
#pragma unroll
      for (int s = SUB - 1; s >= 0; --s) {
        const int blk = s / BLK;
        const float wv = ws[(r0 + s) * D + i];
        const float kv = bf(ks[(r0 + s) * BSTR + i]);
        if (s % BLK == BLK - 1) f4 = 1.f;
        kf[s * FSTR + i] = tf32(kv * f);
        float y = kv * f4;
#pragma unroll
        for (int qa = blk + 1; qa < SUB / BLK; ++qa) {
          if (qa > blk + 1) y *= wb[qa - 1];
          ys[(y_row(qa) + s) * FSTR + i] = tf32(y);
        }
        f *= wv;
        f4 *= wv;
        if (s % BLK == 0) wb[blk] = f4;
      }
    } else if (warp == 4) {
      // dA[s][t] = do_s . v_t: bf16 operands, exact products
      float cc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* o0 = os + (r0 + gq) * BSTR + 16 * kk + 2 * tg;
        const __nv_bfloat16* o1 = o0 + 8 * BSTR;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(o0);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(o1);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(o0 + 8);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(o1 + 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* vp =
              vs + (r0 + 8 * nt + gq) * BSTR + 16 * kk + 2 * tg;
          mma_bf16(cc[nt], a0, a1, a2, a3,
                   *reinterpret_cast<const uint32_t*>(vp),
                   *reinterpret_cast<const uint32_t*>(vp + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = gq + 8 * (e >> 1), t = 8 * nt + 2 * tg + (e & 1);
          const int qs = s / BLK, kt = t / BLK;
          das[s * ASTR + t] = cc[nt][e];
          if (qs >= 1 && t < BLK * qs)
            dys[s * DYSTR + y_row(qs) + t] = tf32(cc[nt][e]);
          if (kt < SUB / BLK - 1 && s >= BLK * (kt + 1))
            dxs[t * DYSTR + xt_row(kt) + s - BLK * (kt + 1)] =
                tf32(cc[nt][e]);
        }
    } else if (warp == 5) {
      float u8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) u8[i] = us[8 * (lane & 7) + i];
      scores_within(rs + r0 * BSTR, ks + r0 * BSTR, ws + r0 * D, u8, as,
                    lane);
    } else {
      // rowsum(G * S), a lane a row, columns rotated by the lane (no bank
      // conflicts)
      const int i = (warp - 6) * 32 + lane;
      float acc = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < D; ++jj) {
        const int j = (jj + lane) & (D - 1);
        acc = fmaf(gq_[i * FSTR + j], s_now[i * FSTR + j], acc);
      }
      rsum[i] = acc;
    }
    __syncthreads();

    // ---- B: the products on the tensor cores ----
    if (warp < 4) {
      // warps 0-1: S do and dr's across-block sum DY Y; warps 2-3: G v and
      // dk's DX Xt; channels [32 (warp % 2), +32)
      const bool is_dr = warp < 2;
      const int c0 = 32 * (warp & 1);
      const __nv_bfloat16* xin = is_dr ? os : vs;       // do or v
      const float* st = is_dr ? s_now : gq_;             // S or G
      const float* dmat = is_dr ? dys : dxs;
      const float* bmat = is_dr ? ys : xt;
      float pr[4][4] = {}, ac[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int j = 8 * kk + 2 * tg;     // k slots tg, tg + 4: j, j + 1
        const float2 x0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xin + (r0 + gq) * BSTR +
                                                     j));
        const float2 x1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                xin + (r0 + gq + 8) * BSTR + j));
        float2 sv[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sv[nt] = *reinterpret_cast<const float2*>(
              st + (c0 + 8 * nt + gq) * FSTR + j);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)          // S = hi + lo: hi
          mma_tf32(pr[nt], x0.x, x1.x, x0.y, x1.y, tf32(sv[nt].x),
                   tf32(sv[nt].y));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)          // lo
          mma_tf32(pr[nt], x0.x, x1.x, x0.y, x1.y,
                   tf32(sv[nt].x - tf32(sv[nt].x)),
                   tf32(sv[nt].y - tf32(sv[nt].y)));
      }
#pragma unroll
      for (int kk = 0; kk < NY / 8; ++kk) {
        const float* d0 = dmat + gq * DYSTR + 8 * kk + tg;
        const float* d1 = d0 + 8 * DYSTR;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* bp = bmat + (8 * kk + tg) * FSTR + c0 + 8 * nt + gq;
          mma_tf32(ac[nt], d0[0], d1[0], d0[4], d1[4], bp[0], bp[4 * FSTR]);
        }
      }
      float* raw = is_dr ? sds : gvs;
      float* across = is_dr ? drx : dkx;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int o = (gq + 8 * hf) * FSTR + c0 + 8 * nt + 2 * tg;
          *reinterpret_cast<float2*>(raw + o) =
              make_float2(pr[nt][2 * hf], pr[nt][2 * hf + 1]);
          *reinterpret_cast<float2*>(across + o) =
              make_float2(ac[nt][2 * hf], ac[nt][2 * hf + 1]);
        }
    } else if (warp < 6) {
      // dv = (k F)^T G + A^T do, columns [32 (warp - 4), +32)
      const int c0 = 32 * (warp - 4);
      float acc[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float* a0 = kf + gq * FSTR + 8 * kk + tg;
        const float* a1 = a0 + 8 * FSTR;
        float gv[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* gp = gq_ + (8 * kk + tg) * FSTR + c0 + 8 * nt + gq;
          gv[nt][0] = gp[0];
          gv[nt][1] = gp[4 * FSTR];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)          // G = hi + lo: hi
          mma_tf32(acc[nt], a0[0], a1[0], a0[4], a1[4], tf32(gv[nt][0]),
                   tf32(gv[nt][1]));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)          // lo
          mma_tf32(acc[nt], a0[0], a1[0], a0[4], a1[4],
                   tf32(gv[nt][0] - tf32(gv[nt][0])),
                   tf32(gv[nt][1] - tf32(gv[nt][1])));
      }
      asm volatile("bar.sync 1, 96;\n" ::: "memory");   // A is complete
#pragma unroll
      for (int kk = 0; kk < SUB / 8; ++kk) {
        const float* a0 = as + (8 * kk + tg) * ASTR + gq;   // A^T[t][s]
        const float* a2 = a0 + 4 * ASTR;
        const __nv_bfloat16* b0 = os + (r0 + 8 * kk + tg) * BSTR + c0 + gq;
        const __nv_bfloat16* b1 = b0 + 4 * BSTR;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32(acc[nt], a0[0], a0[8], a2[0], a2[8], bf(b0[8 * nt]),
                   bf(b1[8 * nt]));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = gq + 8 * hf;
          if (t0 + r0 + t < L)
            *reinterpret_cast<__nv_bfloat162*>(
                dv + base + (int64_t)(t0 + r0 + t) * row + c0 + 8 * nt +
                2 * tg) = __floats2bfloat162_rn(acc[nt][2 * hf],
                                                acc[nt][2 * hf + 1]);
        }
    } else {
      if (warp == 6) {
        scores_across(xq, ys, as, lane);
        asm volatile("bar.sync 1, 96;\n" ::: "memory");   // A to warps 4-5
      }
      if (q + 1 < nq) {
        // S_q+1 = diag(E) S_q + (k F)^T v into the other buffer: rows [32
        // (warp - 6), +32), all columns
        const int i0 = 32 * (warp - 6);
        float* s_next = ss + ((q + 1) & 1) * D * FSTR;
        float acc[2][D / 8][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int ra = i0 + 16 * mt + gq;
          const float e0 = eq[q * D + ra], e1 = eq[q * D + ra + 8];
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] = (e < 2 ? e0 : e1) *
                               s_now[(ra + 8 * (e >> 1)) * FSTR + 8 * nt +
                                     2 * tg + (e & 1)];
        }
#pragma unroll
        for (int kk = 0; kk < SUB / 8; ++kk) {
          const __nv_bfloat16* b0 = vs + (r0 + 8 * kk + tg) * BSTR + gq;
          const __nv_bfloat16* b1 = b0 + 4 * BSTR;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* a0 = kf + (8 * kk + tg) * FSTR + i0 + 16 * mt + gq;
            const float* a2 = a0 + 4 * FSTR;
#pragma unroll
            for (int nt = 0; nt < D / 8; ++nt)
              mma_tf32(acc[mt][nt], a0[0], a0[8], a2[0], a2[8],
                       bf(b0[8 * nt]), bf(b1[8 * nt]));
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              *reinterpret_cast<float2*>(
                  s_next + (i0 + 16 * mt + gq + 8 * hf) * FSTR + 8 * nt +
                  2 * tg) = make_float2(acc[mt][nt][2 * hf],
                                        acc[mt][nt][2 * hf + 1]);
      }
    }
    __syncthreads();

    // ---- C: dw (warps 0-3), dr and dk (warps 4-7), a thread a channel ----
    const int i = tid & (D - 1);
    float wv[SUB], kv[SUB], rv[SUB], fv[SUB], res[SUB];
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      wv[t] = ws[(r0 + t) * D + i];
      kv[t] = bf(ks[(r0 + t) * BSTR + i]);
      rv[t] = bf(rs[(r0 + t) * BSTR + i]);
    }
    {
      float f = 1.f;                    // F_t, as the decays above make it
#pragma unroll
      for (int t = SUB - 1; t >= 0; --t) {
        fv[t] = f;
        f *= wv[t];
      }
    }
    if (warp < 4) {
      const int part = tid >> 6;
      if (part == 0) {
        // E F rowsum(G * S) + F q, then half of Z's sum
        const float rsv = rsum[i];
        float qv = 0.f;
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          res[t] = es[(r0 + t) * FSTR + i] * fv[t] * rsv + fv[t] * qv;
          qv = fmaf(wv[t], qv, kv[t] * gvs[t * FSTR + i]);
        }
        dw_z<kZ0>(wv, kv, rv, das, res);
      } else {
        // E p, then the other half of Z's sum
        float pv = 0.f;
#pragma unroll
        for (int t = SUB - 1; t >= 0; --t) {
          res[t] = es[(r0 + t) * FSTR + i] * pv;
          pv = fmaf(wv[t], pv, rv[t] * sds[t * FSTR + i]);
        }
        dw_z<kZ1>(wv, kv, rv, das, res);
#pragma unroll
        for (int t = 0; t < SUB; ++t) dwp[t * D + i] = res[t];
      }
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      if (part == 0) {
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          if (t0 + r0 + t < L)
            dw[base + (int64_t)(t0 + r0 + t) * row + i] =
                res[t] + dwp[t * D + i];
          du_acc = fmaf(rv[t] * kv[t], das[t * ASTR + t], du_acc);
        }
      }
    } else {
      // warps 4-5 dr = E (S do) + Xd (DY Y) + pairs within + bonus, warps
      // 6-7 dk = F (G v) + Sf (DX Xt) + pairs within + bonus
      const bool is_dr = warp < 6;
      const float ui = us[i];
#pragma unroll
      for (int g = 0; g < SUB; g += BLK) {
        float dec_b = 1.f;              // Xd (forwards), Sf (backwards)
#pragma unroll
        for (int m = 0; m < BLK; ++m) {
          if (is_dr) {
            const int s = g + m;
            float acc = das[s * ASTR + s] * (ui * kv[s]);
            float dec = 1.f;
#pragma unroll
            for (int t = s - 1; t >= g; --t) {
              acc = fmaf(das[s * ASTR + t], kv[t] * dec, acc);
              dec *= wv[t];
            }
            res[s] = es[(r0 + s) * FSTR + i] * sds[s * FSTR + i] +
                     dec_b * drx[s * FSTR + i] + acc;
            dec_b *= wv[s];
          } else {
            const int t = g + BLK - 1 - m;
            float acc = das[t * ASTR + t] * (ui * rv[t]);
            float dec = 1.f;
#pragma unroll
            for (int s = t + 1; s < g + BLK; ++s) {
              acc = fmaf(das[s * ASTR + t], rv[s] * dec, acc);
              dec *= wv[s];
            }
            res[t] = fv[t] * gvs[t * FSTR + i] + dec_b * dkx[t * FSTR + i] +
                     acc;
            dec_b *= wv[t];
          }
        }
      }
      __nv_bfloat16* out = is_dr ? dr : dk;
#pragma unroll
      for (int t = 0; t < SUB; ++t)
        if (t0 + r0 + t < L)
          out[base + (int64_t)(t0 + r0 + t) * row + i] =
              __float2bfloat16_rn(res[t]);
    }
    __syncthreads();
  }
  if (tid < D) du_part[((int64_t)bh * nc + c) * D + tid] = du_acc;
}

// ---- launch 3: du (H, D) = du_part (B, H, nc, D) summed over the chunks
// and then b, in order ----
__global__ void rwkv6_bwd_chunked_du_kernel(const float* __restrict__ du_part,
                                            float* __restrict__ du, int B,
                                            int H, int nc) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= H * D) return;
  const int h = n / D, i = n % D;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = du_part + ((int64_t)(b * H + h) * nc) * D + i;
    float part = 0.f;
    for (int c = 0; c < nc; ++c) part += p[(int64_t)c * D];
    acc += part;
  }
  du[n] = acc;
}

}  // namespace

// The plan's fields (kernels/rwkv6_bwd.py :: plan) must be this file's:
// states_grid 2 B H and chunk_grid B H ceil(L / 64) blocks of `threads`
// threads, `states_smem` and `smem` dynamic shared bytes.  r, k, v, dout,
// dr, dk, dv (bf16), w, dw (float32) 16-byte aligned; d 64.  scratch
// (2, B H, ceil(L / 64), D, D) and du_part (B, H, ceil(L / 64), D) are
// float32 the caller allocates.
extern "C" int rwkv6_bwd_chunked_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const void* dout, void* dr, void* dk, void* dv,
    float* dw, float* du, float* du_part, float* scratch, int b, int L, int h,
    int d, int states_grid, int chunk_grid, int threads, int states_smem,
    int smem, void* stream) {
  const int64_t nc = ((int64_t)L + CHUNK - 1) / CHUNK;
  if (b <= 0 || L <= 0 || h <= 0 || d != D ||
      (int64_t)2 * b * h != states_grid ||
      (int64_t)b * h * nc != chunk_grid || threads != THREADS ||
      states_smem != ST_SMEM || smem != SMEM ||
      (int64_t)b * L * h * D > 0x7FFFFFFFLL ||
      ((uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)w |
       (uintptr_t)dout | (uintptr_t)dr | (uintptr_t)dk | (uintptr_t)dv |
       (uintptr_t)dw | (uintptr_t)scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_bwd_states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ST_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv6_bwd_chunk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const auto* rb = (const __nv_bfloat16*)r;
  const auto* kb = (const __nv_bfloat16*)k;
  const auto* vb = (const __nv_bfloat16*)v;
  const auto* ob = (const __nv_bfloat16*)dout;
  rwkv6_bwd_states_kernel<<<states_grid, THREADS, ST_SMEM, s>>>(
      rb, kb, vb, ob, w, scratch, b, L, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_chunk_kernel<<<chunk_grid, THREADS, SMEM, s>>>(
      rb, kb, vb, ob, w, u, scratch, (__nv_bfloat16*)dr, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, dw, du_part, b, L, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_chunked_du_kernel<<<(h * D + 255) / 256, 256, 0, s>>>(
      du_part, du, b, h, (int)nc);
  return (int)cudaGetLastError();
}
