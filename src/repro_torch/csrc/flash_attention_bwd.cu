// The gradients dQ, dK and dV of the port's attention function
// (kernels/ops.py :: mha, the function of csrc/flash_attention*.cu and
// flash_decode.cu), on the CUDA cores, float32 accumulation.
//
// Replaces no TPU kernel: the reference trains through its jnp
// online-softmax `mha` (src/repro/models/attention.py:52), which
// jax.value_and_grad differentiates, and has no Pallas backward.  This is
// the port's own gradient of the flash-attention kernel (src/repro/kernels/
// flash_attention.py:96), so that training on the card never runs the
// plain version.
//
// q (B, Sq, H, hd); k, v (B, Skv, Hkv, hd); o, dO (B, Sq, H, hd); float32 or
// bfloat16, hd <= 256, query head h reading kv head h / (H / Hkv).  Key j
// is kept for query row r (position i = q_offset + r) iff j < kv_len, and
// (not causal or j <= i), and (no window or j > i - window).  With
// x = scale q.k and s = cap tanh(x / cap) (s = x without a cap):
//
//     P = softmax_kept(s), dV = P^T dO, dP = dO V^T, D = rowsum(dO * O),
//     dS = P (dP - D), dX = dS (1 - (s / cap)^2),
//     dQ = scale dX K, dK = scale dX^T Q,
//
// dK and dV of a kv head summed over its H / Hkv query heads; a row with no
// kept key has P = 0 and adds nothing.  Three kernels on one stream:
//
//   1. fa_bwd_prep, a block a (b, head, 32-row query tile): each row's
//      log-sum-exp over its kept keys (the forward kernels are left as they
//      are and keep none) and D;
//   2. fa_bwd_dkdv, a block a (b, kv head, 32-key tile): dK and dV of its
//      keys in registers, looping over the query tiles of its H / Hkv heads
//      that can reach a key of the tile;
//   3. fa_bwd_dq, a block a (b, head, 32-row query tile): dQ of its rows in
//      registers, looping over the key tiles its rows can reach.
//
// Each gradient element is written by one thread of one block, after a sum
// in a fixed order: no atomics, the same bits run to run.  Kernels 2 and 3
// each recompute the (32 x 32) tiles of P and dS from Q, K, V, dO, the
// log-sum-exp and D, with the same code and the same fmaf order as the
// prep pass, so P = exp(s - lse) never exceeds 1.
//
// What bounds it on an H100: operations.  The function needs five products
// of 2 hd operations a kept (query, key) pair; this design does eight (the
// score product three times, dO V^T twice) on the CUDA cores in float32,
// with 32 x 32 tiles staged in shared memory (a 2 x 2 micro-tile a thread
// for the scores, 4 x 8 for the sums), one 140 KB block an SM at hd 256.
// It is the design that is right first; tensor cores (mma.sync / wgmma on
// bf16 tiles) and one pass for dQ with dK, dV are the way to its bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 32;          // query rows a tile
constexpr int BK = 32;          // keys a tile
constexpr int THREADS = 256;
constexpr int HD_MAX = 256;
constexpr int SLD = BK + 1;     // row stride of the P and dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;     // (B, H, Sq)
  float* dsum;    // (B, H, Sq)
  int B, Sq, Skv, H, Hkv, hd, causal, window, q_offset, kv_len;
  float cap, scale;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) { return __float2bfloat16(x); }

// Whether query row r (of Sq) keeps key j, by mha_ref's masks.
__device__ __forceinline__ bool kept(const Params& p, int r, int j) {
  if (r >= p.Sq || j >= p.kv_len) return false;
  const int i = p.q_offset + r;
  if (p.causal && j > i) return false;
  if (p.window > 0 && j <= i - p.window) return false;
  return true;
}

// Rows [r0, r0 + n) of head h of batch b of a (B, S, heads, hd) tensor into
// dst[n][ld] as float32; rows at or past S are zero.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int b, int r0, int S,
                          int heads, int h, int hd, int ld, int n) {
  for (int e = threadIdx.x; e < n * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd, row = r0 + r;
    float x = 0.f;
    if (row < S) x = to_f(src[(((size_t)b * S + row) * heads + h) * hd + d]);
    dst[r * ld + d] = x;
  }
}

// The log-sum-exp and D of rows [r0, r0 + BR) into shared memory.
__device__ void load_row_stats(float* lse_s, float* d_s, const Params& p,
                               int b, int h, int r0) {
  if (threadIdx.x < BR) {
    const int r = r0 + threadIdx.x;
    const size_t at = ((size_t)b * p.H + h) * p.Sq + r;
    lse_s[threadIdx.x] = r < p.Sq ? p.lse[at] : 0.f;
    d_s[threadIdx.x] = r < p.Sq ? p.dsum[at] : 0.f;
  }
}

// Thread (ty, tx) = (tid / 16, tid % 16) of the score layout owns rows
// 2 ty, 2 ty + 1 and keys tx, tx + 16 of a tile: acc[i][jj] += a_row . b_key
// over hd, in one fmaf order.
__device__ __forceinline__ void dot_2x2(const float* a, const float* bm,
                                        int ld, int hd, float acc[2][2]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* a0 = a + (2 * ty) * ld;
  const float* a1 = a0 + ld;
  const float* b0 = bm + tx * ld;
  const float* b1 = bm + (tx + 16) * ld;
  for (int d = 0; d < hd; ++d) {
    const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
    acc[0][0] = fmaf(x0, y0, acc[0][0]);
    acc[0][1] = fmaf(x0, y1, acc[0][1]);
    acc[1][0] = fmaf(x1, y0, acc[1][0]);
    acc[1][1] = fmaf(x1, y1, acc[1][1]);
  }
}

// s = cap tanh(x / cap) (x without a cap) of x = scale * dot; *dcap gets
// ds/dx = 1 - tanh^2.
__device__ __forceinline__ float capped(const Params& p, float dot,
                                        float* dcap) {
  const float x = dot * p.scale;
  if (p.cap > 0.f) {
    const float t = tanhf(x / p.cap);
    *dcap = 1.f - t * t;
    return p.cap * t;
  }
  *dcap = 1.f;
  return x;
}

// P and dS of the tile of rows [r0, r0 + BR) and keys [c0, c0 + BK) into
// ps[BR][SLD] and dss[BR][SLD]; 0 where the pair is not kept.
__device__ void tile_p_ds(const Params& p, const float* qs, const float* dos,
                          const float* ks, const float* vs,
                          const float* lse_s, const float* d_s, int ld,
                          int r0, int c0, float* ps, float* dss) {
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  dot_2x2(qs, ks, ld, p.hd, s);
  dot_2x2(dos, vs, ld, p.hd, dp);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int r = 2 * ty + i, c = tx + 16 * jj;
      float pv = 0.f, dsv = 0.f;
      if (kept(p, r0 + r, c0 + c)) {
        float dcap;
        const float sv = capped(p, s[i][jj], &dcap);
        pv = expf(sv - lse_s[r]);
        dsv = pv * (dp[i][jj] - d_s[r]) * dcap;
      }
      ps[r * SLD + c] = pv;
      dss[r * SLD + c] = dsv;
    }
  }
}

// Keys [j_lo, j_hi) that rows [r0, r0 + BR) can reach.
__device__ __forceinline__ void key_range(const Params& p, int r0, int* j_lo,
                                          int* j_hi) {
  const int r_last = min(r0 + BR, p.Sq) - 1;
  *j_lo = p.window > 0 ? max(0, p.q_offset + r0 - p.window + 1) : 0;
  *j_hi = p.causal ? min(p.kv_len, p.q_offset + r_last + 1) : p.kv_len;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_prep(Params p) {
  extern __shared__ float sm[];
  const int ld = p.hd + 1;
  float* qs = sm;
  float* ks = qs + BR * ld;
  float* ss = ks + BK * ld;
  const int r0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.Hkv);
  load_tile(qs, (const T*)p.q, b, r0, p.Sq, p.H, h, p.hd, ld, BR);
  const int row = threadIdx.x / 8, lane = threadIdx.x % 8;
  float m = -INFINITY, l = 0.f;
  int j_lo, j_hi;
  key_range(p, r0, &j_lo, &j_hi);
  for (int c0 = (j_lo / BK) * BK; c0 < j_hi; c0 += BK) {
    __syncthreads();
    load_tile(ks, (const T*)p.k, b, c0, p.Skv, p.Hkv, kh, p.hd, ld, BK);
    __syncthreads();
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    dot_2x2(qs, ks, ld, p.hd, s);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int r = 2 * ty + i, c = tx + 16 * jj;
        float dcap;
        ss[r * SLD + c] = kept(p, r0 + r, c0 + c)
            ? capped(p, s[i][jj], &dcap) : -INFINITY;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
      const float sv = ss[row * SLD + lane * (BK / 8) + t];
      if (sv == -INFINITY) continue;
      if (sv > m) {
        l = l * expf(m - sv) + 1.f;
        m = sv;
      } else {
        l += expf(sv - m);
      }
    }
  }
  // the row's (m, l) over its 8 lanes
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mm = fmaxf(m, m2);
    float ln = 0.f;
    if (m != -INFINITY) ln += l * expf(m - mm);
    if (m2 != -INFINITY) ln += l2 * expf(m2 - mm);
    m = mm;
    l = ln;
  }
  // D = rowsum(dO * O) of the row, its hd split over the 8 lanes
  const int r = r0 + row;
  float dsum = 0.f;
  if (r < p.Sq) {
    const size_t base = (((size_t)b * p.Sq + r) * p.H + h) * p.hd;
    const T* dov = (const T*)p.dout + base;
    const T* ov = (const T*)p.o + base;
    for (int d = lane; d < p.hd; d += 8)
      dsum = fmaf(to_f(dov[d]), to_f(ov[d]), dsum);
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
  if (lane == 0 && r < p.Sq) {
    const size_t at = ((size_t)b * p.H + h) * p.Sq + r;
    p.lse[at] = l > 0.f ? m + logf(l) : 0.f;
    p.dsum[at] = dsum;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_dkdv(Params p) {
  extern __shared__ float sm[];
  const int ld = p.hd + 1;
  float* ks = sm;
  float* vs = ks + BK * ld;
  float* qs = vs + BK * ld;
  float* dos = qs + BR * ld;
  float* ps = dos + BR * ld;
  float* dss = ps + BR * SLD;
  float* lse_s = dss + BR * SLD;
  float* d_s = lse_s + BR;
  const int c0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.Hkv;
  load_tile(ks, (const T*)p.k, b, c0, p.Skv, p.Hkv, kh, p.hd, ld, BK);
  load_tile(vs, (const T*)p.v, b, c0, p.Skv, p.Hkv, kh, p.hd, ld, BK);
  // thread (kq, dl) sums keys 4 kq .. 4 kq + 3 at d = dl + 32 jd
  const int kq = threadIdx.x / 32, dl = threadIdx.x % 32;
  float acc_k[4][HD_MAX / 32], acc_v[4][HD_MAX / 32];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < HD_MAX / 32; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.f;
  if (c0 < p.kv_len) {
    const int c_last = min(c0 + BK, p.kv_len) - 1;
    const int r_lo = p.causal ? max(0, c0 - p.q_offset) : 0;
    const int r_hi = p.window > 0
        ? min(p.Sq, c_last + p.window - p.q_offset) : p.Sq;
    for (int hh = 0; hh < g; ++hh) {
      const int h = kh * g + hh;
      for (int r0 = (r_lo / BR) * BR; r0 < r_hi; r0 += BR) {
        __syncthreads();
        load_tile(qs, (const T*)p.q, b, r0, p.Sq, p.H, h, p.hd, ld, BR);
        load_tile(dos, (const T*)p.dout, b, r0, p.Sq, p.H, h, p.hd, ld, BR);
        load_row_stats(lse_s, d_s, p, b, h, r0);
        __syncthreads();
        tile_p_ds(p, qs, dos, ks, vs, lse_s, d_s, ld, r0, c0, ps, dss);
        __syncthreads();
        for (int r = 0; r < BR; ++r) {
          float pk[4], dk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pk[i] = ps[r * SLD + 4 * kq + i];
            dk[i] = dss[r * SLD + 4 * kq + i];
          }
#pragma unroll
          for (int jd = 0; jd < HD_MAX / 32; ++jd) {
            const int d = dl + 32 * jd;
            if (d < p.hd) {
              const float a = dos[r * ld + d], qv = qs[r * ld + d];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc_v[i][jd] = fmaf(pk[i], a, acc_v[i][jd]);
                acc_k[i][jd] = fmaf(dk[i], qv, acc_k[i][jd]);
              }
            }
          }
        }
      }
    }
  }
  T* dk_out = (T*)p.dk;
  T* dv_out = (T*)p.dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + 4 * kq + i;
    if (key >= p.Skv) continue;
    const size_t base = (((size_t)b * p.Skv + key) * p.Hkv + kh) * p.hd;
#pragma unroll
    for (int jd = 0; jd < HD_MAX / 32; ++jd) {
      const int d = dl + 32 * jd;
      if (d < p.hd) {
        dk_out[base + d] = from_f<T>(acc_k[i][jd] * p.scale);
        dv_out[base + d] = from_f<T>(acc_v[i][jd]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_dq(Params p) {
  extern __shared__ float sm[];
  const int ld = p.hd + 1;
  float* qs = sm;
  float* dos = qs + BR * ld;
  float* ks = dos + BR * ld;
  float* vs = ks + BK * ld;
  float* ps = vs + BK * ld;
  float* dss = ps + BR * SLD;
  float* lse_s = dss + BR * SLD;
  float* d_s = lse_s + BR;
  const int r0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.Hkv);
  load_tile(qs, (const T*)p.q, b, r0, p.Sq, p.H, h, p.hd, ld, BR);
  load_tile(dos, (const T*)p.dout, b, r0, p.Sq, p.H, h, p.hd, ld, BR);
  load_row_stats(lse_s, d_s, p, b, h, r0);
  // thread (rq, dl) sums rows 4 rq .. 4 rq + 3 at d = dl + 32 jd
  const int rq = threadIdx.x / 32, dl = threadIdx.x % 32;
  float acc[4][HD_MAX / 32];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < HD_MAX / 32; ++jd) acc[i][jd] = 0.f;
  int j_lo, j_hi;
  key_range(p, r0, &j_lo, &j_hi);
  for (int c0 = (j_lo / BK) * BK; c0 < j_hi; c0 += BK) {
    __syncthreads();
    load_tile(ks, (const T*)p.k, b, c0, p.Skv, p.Hkv, kh, p.hd, ld, BK);
    load_tile(vs, (const T*)p.v, b, c0, p.Skv, p.Hkv, kh, p.hd, ld, BK);
    __syncthreads();
    tile_p_ds(p, qs, dos, ks, vs, lse_s, d_s, ld, r0, c0, ps, dss);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(4 * rq + i) * SLD + c];
#pragma unroll
      for (int jd = 0; jd < HD_MAX / 32; ++jd) {
        const int d = dl + 32 * jd;
        if (d < p.hd) {
          const float kv = ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(dr[i], kv, acc[i][jd]);
        }
      }
    }
  }
  T* dq_out = (T*)p.dq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * rq + i;
    if (r >= p.Sq) continue;
    const size_t base = (((size_t)b * p.Sq + r) * p.H + h) * p.hd;
#pragma unroll
    for (int jd = 0; jd < HD_MAX / 32; ++jd) {
      const int d = dl + 32 * jd;
      if (d < p.hd) dq_out[base + d] = from_f<T>(acc[i][jd] * p.scale);
    }
  }
}

template <typename T>
int launch_all(const Params& p, cudaStream_t stream) {
  const int ld = p.hd + 1;
  const size_t prep_bytes = ((BR + BK) * ld + BR * SLD) * sizeof(float);
  const size_t tile_bytes =
      (2 * (BR + BK) * ld + 2 * BR * SLD + 2 * BR) * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(fa_bwd_prep<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)prep_bytes)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(fa_bwd_dkdv<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)tile_bytes)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(fa_bwd_dq<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)tile_bytes)) != cudaSuccess)
    return (int)err;
  const dim3 gq((p.Sq + BR - 1) / BR, p.H, p.B);
  const dim3 gk((p.Skv + BK - 1) / BK, p.Hkv, p.B);
  fa_bwd_prep<T><<<gq, THREADS, prep_bytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dkdv<T><<<gk, THREADS, tile_bytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dq<T><<<gq, THREADS, tile_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  lse and dsum are (B, H, Sq) float32
// scratch that the wrapper allocates.  Returns cudaGetLastError() after the
// launches (a refused launch is never silent).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
    int dtype, int B, int Sq, int Skv, int H, int Hkv, int hd, int causal,
    int window, float cap, int q_offset, int kv_len, float scale,
    cudaStream_t stream) {
  if (hd < 1 || hd > HD_MAX || Hkv < 1 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, dq, dk, dv, lse, dsum, B, Sq, Skv, H, Hkv, hd,
           causal, window, q_offset, kv_len, cap, scale};
  if (dtype == 0) return launch_all<float>(p, stream);
  if (dtype == 1) return launch_all<__nv_bfloat16>(p, stream);
  return (int)cudaErrorInvalidValue;
}
