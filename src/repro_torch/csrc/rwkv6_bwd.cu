// Gradient of the RWKV-6 (Finch) WKV recurrence from a zero state, on
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its jnp
//   `_wkv_chunked` (src/repro/models/rwkv.py) with jax.grad and has no
//   Pallas backward.  This is the port's own gradient of the function of
//   src/repro/kernels/rwkv6_scan.py :: rwkv6_scan (row 11 of the port's
//   kernels), which the model's time mix runs in training:
//     r, k, v, do (B, L, H, D) float32 or bfloat16, w (B, L, H, D)
//     float32, u (H, D) float32; for each (b, h), with S_t the state
//     before token t (S_0 = 0) and dS_t its gradient (dS_L = 0):
//       out_t  = r_t . (S_t + diag(u) k_t v_t^T)
//       S_t+1  = diag(w_t) S_t + k_t v_t^T
//       dS_t   = r_t do_t^T + diag(w_t) dS_t+1
//       dr_t   = S_t do_t + u * k_t (v_t . do_t)
//       dk_t   = dS_t+1 v_t + u * r_t (v_t . do_t)
//       dv_t   = dS_t+1^T k_t + (r_t . (u * k_t)) do_t
//       dw_t   = rowsum(dS_t+1 * S_t)            (row i: sum_x, elementwise)
//       du     = sum over b, t of r_t * k_t (v_t . do_t)
//     dr, dk, dv in r's type, dw and du float32; every sum in float32.
//   D is 32 or 64; any L >= 1.
//
// Why dw is taken from S and dS directly: dw_t = dlog w_t / w_t, and
//   dlog w follows from dr and dk by two reverse cumulative sums, but in
//   float32 that difference of two long sums cancels: at w_t near 1e-6
//   beside a w_t+1 near 1 the quotient loses every digit.  The direct form
//   has no cancellation at any decay.
//
// Bound on the H100 at the rwkv6-3b training shape (B 2, L 2048, H 40,
//   D 64, bf16): 231 MB (r, k, v, do, dr, dk, dv in bf16, w and dw in
//   float32) against the 14 D^2 float32 operations a (token, head) that
//   the gradient needs (one state step and one dS step, 3 D^2 each; four
//   D-long dots a row, 8 D^2), 9.4 GFLOP on the CUDA cores: operations
//   bound it (140 us at 67 TFLOP/s).  This design does 20 D^2 (the state
//   step again in the rebuild, the dS step in two copies).  A chunked
//   tensor-core form would be bounded by the TF32 rate instead.
//
// Design (simple and right first; speed is later work).  One block of 2 D
//   threads for each (b, h), two sweeps:
//   - Forward: the state is held in registers (thread (c, half) holds
//     S[c][half * D/2 .. +D/2)) and written to a scratch every SUB tokens:
//     ckpt (B * H, ceil(L / SUB), D, D), the state before token m * SUB.
//     S is rounded as `rwkv6_scan.cu` and `ref.wkv_ref` round it (the
//     products, then their sum; no fma), so these are wkv_ref's states.
//   - Backward, sub-block by sub-block from the last: stage the SUB
//     tokens' r, k, v, w, do in shared memory as float32; rebuild the
//     sub-block's SUB states from its checkpoint into shared memory (rows
//     padded to D + 4 floats: float4 reads of a row by a warp touch every
//     bank once); then walk its tokens backwards.  Threads [0, D) each
//     hold row c of dS (for dk and dw), threads [D, 2 D) each column x of
//     dS (for dv, and row x of S_t for dr): both copies step the same
//     dS_t = r_t do_t^T + diag(w_t) dS_t+1, so no reduction crosses
//     threads.  Each thread reads back only the checkpoint elements it
//     wrote, so the sweeps need no fence.
//   - du: each row thread sums its channel over the block's tokens in
//     order into du_part (B, H, D); a second kernel sums over b in order.
//   No atomics: two launches give the same bits.
//   Known weaknesses: B * H blocks of 2 D threads (80 of 128 at the
//   training shape, one a SM for the 150 KB of shared memory), the
//   sequential walk over L on the CUDA cores, the states rebuilt once more
//   in the backward sweep, the checkpoint scratch (335.5 MB at the
//   training shape, written and read once more a call on top of the 231
//   MB the gradient moves).  The redesign is csrc/rwkv6_bwd_chunked.cu
//   (the `chunked` route: sub-chunks on the tensor cores), which
//   kernels/rwkv6_bwd.py :: route now sends every bf16 call at D 64 from
//   CHUNKED_MIN_LEN tokens, the whole training path.  This file is the
//   `recurrent` route: float32, D 32, bf16 below that length, and any call
//   forced to it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 8;         // tokens a checkpoint and a rebuilt sub-block

template <int D>
struct Layout {
  static constexpr int THREADS = 2 * D;
  static constexpr int HALF = D / 2;       // state elements a thread rebuilds
  static constexpr int STRIDE = D + 4;     // floats a state row in smem
  static constexpr int STATE = D * STRIDE;
  // SUB states; r, k, v, w, do of SUB tokens; u; v.do and r.(u k) a token
  static constexpr int FLOATS = SUB * STATE + 5 * SUB * D + D + 2 * SUB;
  static constexpr int SMEM = FLOATS * 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(2 * D)
rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const T* __restrict__ dout,
                 T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ dw, float* __restrict__ du_part,
                 float* __restrict__ ckpt, int L, int H) {
  using Ly = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* s_state = smem;                         // [SUB][D][STRIDE]
  float* s_r = s_state + SUB * Ly::STATE;        // [SUB][D] each
  float* s_k = s_r + SUB * D;
  float* s_v = s_k + SUB * D;
  float* s_w = s_v + SUB * D;
  float* s_do = s_w + SUB * D;
  float* s_u = s_do + SUB * D;                   // [D]
  float* s_vdo = s_u + D;                        // [SUB]
  float* s_ruk = s_vdo + SUB;                    // [SUB]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                     // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int64_t row = (int64_t)H * D;
  const int64_t base = (int64_t)b * L * row + (int64_t)h * D;
  const int nsub = (L + SUB - 1) / SUB;
  // the state elements this thread carries forward and rebuilds
  const int c = tid % D;
  const int x0 = (tid / D) * Ly::HALF;
  float* my_ckpt = ckpt + (int64_t)bh * nsub * D * D + c * D + x0;
  if (tid < D) s_u[tid] = u[h * D + tid];

  // ---- forward sweep: the checkpoints ----
  float s[Ly::HALF];
#pragma unroll
  for (int i = 0; i < Ly::HALF; ++i) s[i] = 0.f;
  for (int m = 0; m < nsub; ++m) {
    float4* dst = reinterpret_cast<float4*>(my_ckpt + (int64_t)m * D * D);
#pragma unroll
    for (int i4 = 0; i4 < Ly::HALF / 4; ++i4)
      dst[i4] = make_float4(s[4 * i4], s[4 * i4 + 1], s[4 * i4 + 2],
                            s[4 * i4 + 3]);
    if (m == nsub - 1) break;        // no later checkpoint needs its tokens
    const int t0 = m * SUB;
    __syncthreads();                 // the previous sub-block is consumed
    for (int e = tid; e < SUB * D; e += Ly::THREADS) {
      const int64_t idx = base + (int64_t)(t0 + e / D) * row + e % D;
      s_k[e] = to_f32(k[idx]);
      s_v[e] = to_f32(v[idx]);
      s_w[e] = w[idx];
    }
    __syncthreads();
    for (int tt = 0; tt < SUB; ++tt) {
      const float wc = s_w[tt * D + c], kc = s_k[tt * D + c];
      const float4* v4 = reinterpret_cast<const float4*>(s_v + tt * D + x0);
#pragma unroll
      for (int i4 = 0; i4 < Ly::HALF / 4; ++i4) {
        const float4 vv = v4[i4];
        s[4 * i4 + 0] = __fadd_rn(__fmul_rn(wc, s[4 * i4 + 0]),
                                  __fmul_rn(kc, vv.x));
        s[4 * i4 + 1] = __fadd_rn(__fmul_rn(wc, s[4 * i4 + 1]),
                                  __fmul_rn(kc, vv.y));
        s[4 * i4 + 2] = __fadd_rn(__fmul_rn(wc, s[4 * i4 + 2]),
                                  __fmul_rn(kc, vv.z));
        s[4 * i4 + 3] = __fadd_rn(__fmul_rn(wc, s[4 * i4 + 3]),
                                  __fmul_rn(kc, vv.w));
      }
    }
  }

  // ---- backward sweep ----
  const bool by_row = tid < D;       // row `me` of dS, else column `me`
  const int me = by_row ? tid : tid - D;
  float g[D];
#pragma unroll
  for (int i = 0; i < D; ++i) g[i] = 0.f;
  float du_acc = 0.f;
  for (int m = nsub - 1; m >= 0; --m) {
    const int t0 = m * SUB;
    const int n = min(SUB, L - t0);
    __syncthreads();                 // the previous sub-block is consumed
    for (int e = tid; e < n * D; e += Ly::THREADS) {
      const int64_t idx = base + (int64_t)(t0 + e / D) * row + e % D;
      s_r[e] = to_f32(r[idx]);
      s_k[e] = to_f32(k[idx]);
      s_v[e] = to_f32(v[idx]);
      s_w[e] = w[idx];
      s_do[e] = to_f32(dout[idx]);
    }
    const float4* src = reinterpret_cast<const float4*>(
        my_ckpt + (int64_t)m * D * D);
#pragma unroll
    for (int i4 = 0; i4 < Ly::HALF / 4; ++i4) {
      const float4 q = src[i4];
      s[4 * i4] = q.x;
      s[4 * i4 + 1] = q.y;
      s[4 * i4 + 2] = q.z;
      s[4 * i4 + 3] = q.w;
    }
    __syncthreads();                 // the staged tokens are visible
    float4* slot = reinterpret_cast<float4*>(s_state + c * Ly::STRIDE + x0);
#pragma unroll
    for (int i4 = 0; i4 < Ly::HALF / 4; ++i4)
      slot[i4] = make_float4(s[4 * i4], s[4 * i4 + 1], s[4 * i4 + 2],
                             s[4 * i4 + 3]);
    for (int tt = 1; tt < n; ++tt) {
      const float wc = s_w[(tt - 1) * D + c], kc = s_k[(tt - 1) * D + c];
      const float4* v4 =
          reinterpret_cast<const float4*>(s_v + (tt - 1) * D + x0);
      float4* out4 = reinterpret_cast<float4*>(
          s_state + tt * Ly::STATE + c * Ly::STRIDE + x0);
#pragma unroll
      for (int i4 = 0; i4 < Ly::HALF / 4; ++i4) {
        const float4 vv = v4[i4];
        s[4 * i4 + 0] = __fadd_rn(__fmul_rn(wc, s[4 * i4 + 0]),
                                  __fmul_rn(kc, vv.x));
        s[4 * i4 + 1] = __fadd_rn(__fmul_rn(wc, s[4 * i4 + 1]),
                                  __fmul_rn(kc, vv.y));
        s[4 * i4 + 2] = __fadd_rn(__fmul_rn(wc, s[4 * i4 + 2]),
                                  __fmul_rn(kc, vv.z));
        s[4 * i4 + 3] = __fadd_rn(__fmul_rn(wc, s[4 * i4 + 3]),
                                  __fmul_rn(kc, vv.w));
        out4[i4] = make_float4(s[4 * i4], s[4 * i4 + 1], s[4 * i4 + 2],
                               s[4 * i4 + 3]);
      }
    }
    if (tid < 2 * n) {               // v.do (even threads), r.(u k) (odd)
      const int tt = tid >> 1;
      const float* a = (tid & 1) ? s_r + tt * D : s_v + tt * D;
      const float* bb = (tid & 1) ? s_k + tt * D : s_do + tt * D;
      float acc = 0.f;
      for (int i = 0; i < D; ++i)
        acc = fmaf(a[i], (tid & 1) ? s_u[i] * bb[i] : bb[i], acc);
      ((tid & 1) ? s_ruk : s_vdo)[tt] = acc;
    }
    __syncthreads();                 // the states and the dots are visible

    for (int tt = n - 1; tt >= 0; --tt) {
      const int64_t idx = base + (int64_t)(t0 + tt) * row + me;
      const float* rt = s_r + tt * D;
      const float* kt = s_k + tt * D;
      const float* vt = s_v + tt * D;
      const float* wt = s_w + tt * D;
      const float* ot = s_do + tt * D;
      const float4* srow = reinterpret_cast<const float4*>(
          s_state + tt * Ly::STATE + me * Ly::STRIDE);
      const float vdo = s_vdo[tt];
      if (by_row) {
        // g = row `me` of dS_t+1: dk' = g . v_t, dw = g . S_t[me]
        const float4* v4 = reinterpret_cast<const float4*>(vt);
        float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
        for (int x4 = 0; x4 < D / 4; ++x4) {
          const float4 vv = v4[x4], ss = srow[x4];
          a0 = fmaf(g[4 * x4 + 0], vv.x, a0);
          a1 = fmaf(g[4 * x4 + 1], vv.y, a1);
          a0 = fmaf(g[4 * x4 + 2], vv.z, a0);
          a1 = fmaf(g[4 * x4 + 3], vv.w, a1);
          b0 = fmaf(g[4 * x4 + 0], ss.x, b0);
          b1 = fmaf(g[4 * x4 + 1], ss.y, b1);
          b0 = fmaf(g[4 * x4 + 2], ss.z, b0);
          b1 = fmaf(g[4 * x4 + 3], ss.w, b1);
        }
        const float rc = rt[me], kc = kt[me], wc = wt[me];
        store(dk + idx, (a0 + a1) + s_u[me] * rc * vdo);
        dw[idx] = b0 + b1;
        du_acc = fmaf(rc * kc, vdo, du_acc);
        const float4* o4 = reinterpret_cast<const float4*>(ot);
#pragma unroll
        for (int x4 = 0; x4 < D / 4; ++x4) {
          const float4 oo = o4[x4];
          g[4 * x4 + 0] = fmaf(wc, g[4 * x4 + 0], rc * oo.x);
          g[4 * x4 + 1] = fmaf(wc, g[4 * x4 + 1], rc * oo.y);
          g[4 * x4 + 2] = fmaf(wc, g[4 * x4 + 2], rc * oo.z);
          g[4 * x4 + 3] = fmaf(wc, g[4 * x4 + 3], rc * oo.w);
        }
      } else {
        // g = column `me` of dS_t+1: dv' = g . k_t; dr' = S_t[me] . do_t
        const float4* k4 = reinterpret_cast<const float4*>(kt);
        const float4* o4 = reinterpret_cast<const float4*>(ot);
        float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
        for (int i4 = 0; i4 < D / 4; ++i4) {
          const float4 kk = k4[i4], oo = o4[i4], ss = srow[i4];
          a0 = fmaf(g[4 * i4 + 0], kk.x, a0);
          a1 = fmaf(g[4 * i4 + 1], kk.y, a1);
          a0 = fmaf(g[4 * i4 + 2], kk.z, a0);
          a1 = fmaf(g[4 * i4 + 3], kk.w, a1);
          b0 = fmaf(ss.x, oo.x, b0);
          b1 = fmaf(ss.y, oo.y, b1);
          b0 = fmaf(ss.z, oo.z, b0);
          b1 = fmaf(ss.w, oo.w, b1);
        }
        const float om = ot[me];
        store(dv + idx, (a0 + a1) + s_ruk[tt] * om);
        store(dr + idx, (b0 + b1) + s_u[me] * kt[me] * vdo);
        const float4* r4 = reinterpret_cast<const float4*>(rt);
        const float4* w4 = reinterpret_cast<const float4*>(wt);
#pragma unroll
        for (int i4 = 0; i4 < D / 4; ++i4) {
          const float4 rr = r4[i4], ww = w4[i4];
          g[4 * i4 + 0] = fmaf(ww.x, g[4 * i4 + 0], rr.x * om);
          g[4 * i4 + 1] = fmaf(ww.y, g[4 * i4 + 1], rr.y * om);
          g[4 * i4 + 2] = fmaf(ww.z, g[4 * i4 + 2], rr.z * om);
          g[4 * i4 + 3] = fmaf(ww.w, g[4 * i4 + 3], rr.w * om);
        }
      }
    }
  }
  if (by_row) du_part[(int64_t)bh * D + me] = du_acc;
}

// du (H, D) = sum over b, in order, of du_part (B, H, D).
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int b, int hd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hd) return;
  float acc = 0.f;
  for (int j = 0; j < b; ++j) acc += du_part[(int64_t)j * hd + i];
  du[i] = acc;
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const void* dout, void* dr, void* dk, void* dv,
           float* dw, float* du_part, float* ckpt, int b, int L, int h,
           cudaStream_t stream) {
  using Ly = Layout<D>;
  auto kern = rwkv6_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<b * h, Ly::THREADS, Ly::SMEM, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, (const T*)dout, (T*)dr,
      (T*)dk, (T*)dv, dw, du_part, ckpt, L, h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const float* w,
             const float* u, const void* dout, void* dr, void* dk, void* dv,
             float* dw, float* du_part, float* ckpt, int b, int L, int h,
             int d, cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt,
                         b, L, h, stream);
  if (d == 32)
    return launch<T, 32>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt,
                         b, L, h, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The shared bytes a block of the kernel takes at D (0 for another D).
extern "C" int rwkv6_bwd_smem(int d) {
  return d == 64 ? Layout<64>::SMEM : d == 32 ? Layout<32>::SMEM : 0;
}

// dtype (of r, k, v, dout, dr, dk, dv): 0 float32, 1 bfloat16.  d: 32 or
// 64.  du_part (B, H, D) and ckpt (B * H, ceil(L / 8), D, D) are float32
// scratch the caller allocates.
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v,
                                const float* w, const float* u,
                                const void* dout, void* dr, void* dk,
                                void* dv, float* dw, float* du,
                                float* du_part, float* ckpt, int dtype,
                                int b, int L, int h, int d, void* stream) {
  if (b <= 0 || L <= 0 || h <= 0 || (int64_t)b * h > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (dtype == 0)
    err = launch_d<float>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt,
                          b, L, h, d, s);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                  du_part, ckpt, b, L, h, d, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  const int hd = h * d;
  rwkv6_bwd_du_kernel<<<(hd + 255) / 256, 256, 0, s>>>(du_part, du, b, hd);
  return (int)cudaGetLastError();
}
