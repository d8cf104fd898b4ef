// RWKV-6 (Finch) WKV recurrence, batched and from a state, on Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_scan.py :: rwkv6_scan (Pallas body
//   _wkv_kernel), generalized to what the model's time mix needs
//   (src/repro/models/rwkv.py: `_wkv_chunked` in prefill, the one-step
//   recurrence of `rwkv_decode_time_mix` in decode), so both run here:
//     r, k, v (B, L, H, D) float32 or bfloat16, w (B, L, H, D) float32,
//     u (H, D) float32, state (B, H, D, D) float32 read at entry and
//     written back at exit; for each (b, h), with S the state before
//     token t:
//       out_t = r_t . (S + diag(u) k_t v_t^T)
//       S    <- diag(w_t) S + k_t v_t^T
//     out (B, L, H, D) in r's type, accumulated in float32.  D is 32 or
//     64; any L >= 1, no padding.
//
// Bound on the H100: operations at the rwkv6-3b prefill (B 2, L 5000,
//   H 40, D 64): 5 D^2 + 5 D float32 operations a (token, head), 8.3 GFLOP
//   against 310 MB of r, k, v, w, out and the state.  Decode (L 1) is bound
//   by reading and writing the 1.3 MB state.
//
// Design (simple and right first; speed is later work): the per-channel
//   recurrence of the upstream wkv6 CUDA kernel, not the Pallas grid, whose
//   sequential chunk axis carried the state in VMEM scratch.
//   - One block of D threads for each (b, h); thread j holds column j of S
//     (D floats) in registers for the whole sequence, so the state crosses
//     device memory once in and once out.
//   - Tokens are staged TC at a time: each thread loads its channel of r,
//     k, w, v for TC tokens (coalesced rows of the (B, L, H, D) layout,
//     nothing transposed), converts them to float32 and stores r, k, w and
//     r*u in shared memory; one barrier then covers TC tokens.
//   - For each token, thread j computes
//       out_j = sum_i r_i S_ij + (sum_i r_i u_i k_i) v_j
//     over four partial sums (shorter dependency chains), then
//       S_ij = w_i S_ij + k_i v_j
//     rounded as the reference rounds it (the product k_i v_j, the product
//     w_i S_ij, their sum; no fma), so the state is the plain recurrence's
//     bit for bit whatever the output's order of sums.
//   Known weaknesses: only B*H blocks of D threads (80 of 64 at the
//   served shape, on 132 SMs), and the work is sequential over L on the
//   CUDA cores; the chunked tensor-core form is the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;         // tokens staged a barrier

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ state,
                  T* __restrict__ out, int L, int H) {
  __shared__ __align__(16) float r_s[TC][D];
  __shared__ __align__(16) float ru_s[TC][D];
  __shared__ __align__(16) float k_s[TC][D];
  __shared__ __align__(16) float w_s[TC][D];
  __shared__ float v_s[TC][D];

  const int j = threadIdx.x;
  const int bh = blockIdx.x;             // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const float u_j = u[h * D + j];
  float* st = state + (int64_t)bh * D * D;

  float s[D];                            // column j of S
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = st[i * D + j];

  // element (b, t, h, j) of a (B, L, H, D) tensor
  const int64_t row = (int64_t)H * D;
  const int64_t base = (int64_t)b * L * row + (int64_t)h * D + j;

  for (int t0 = 0; t0 < L; t0 += TC) {
    const int n = min(TC, L - t0);
    __syncthreads();                     // the previous run is consumed
    for (int tt = 0; tt < n; ++tt) {
      const int64_t idx = base + (int64_t)(t0 + tt) * row;
      const float rr = to_f32(r[idx]);
      r_s[tt][j] = rr;
      ru_s[tt][j] = rr * u_j;
      k_s[tt][j] = to_f32(k[idx]);
      w_s[tt][j] = w[idx];
      v_s[tt][j] = to_f32(v[idx]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[tt]);
      const float4* ru4 = reinterpret_cast<const float4*>(ru_s[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[tt]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[tt]);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, bonus = 0.f;
#pragma unroll
      for (int i4 = 0; i4 < D / 4; ++i4) {
        const float4 rv = r4[i4], ruv = ru4[i4], kv = k4[i4];
        a0 = fmaf(rv.x, s[4 * i4 + 0], a0);
        a1 = fmaf(rv.y, s[4 * i4 + 1], a1);
        a2 = fmaf(rv.z, s[4 * i4 + 2], a2);
        a3 = fmaf(rv.w, s[4 * i4 + 3], a3);
        bonus = fmaf(ruv.x, kv.x, bonus);
        bonus = fmaf(ruv.y, kv.y, bonus);
        bonus = fmaf(ruv.z, kv.z, bonus);
        bonus = fmaf(ruv.w, kv.w, bonus);
      }
      const float o = ((a0 + a1) + (a2 + a3)) + bonus * vj;
      store(out + base + (int64_t)(t0 + tt) * row, o);
#pragma unroll
      for (int i4 = 0; i4 < D / 4; ++i4) {
        const float4 kv = k4[i4], wv = w4[i4];
        s[4 * i4 + 0] = __fadd_rn(__fmul_rn(wv.x, s[4 * i4 + 0]),
                                  __fmul_rn(kv.x, vj));
        s[4 * i4 + 1] = __fadd_rn(__fmul_rn(wv.y, s[4 * i4 + 1]),
                                  __fmul_rn(kv.y, vj));
        s[4 * i4 + 2] = __fadd_rn(__fmul_rn(wv.z, s[4 * i4 + 2]),
                                  __fmul_rn(kv.z, vj));
        s[4 * i4 + 3] = __fadd_rn(__fmul_rn(wv.w, s[4 * i4 + 3]),
                                  __fmul_rn(kv.w, vj));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) st[i * D + j] = s[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, float* state, void* out, int b, int L, int h,
           int d, cudaStream_t stream) {
  if (d == 64) {
    rwkv6_scan_kernel<T, 64><<<b * h, 64, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, w, u, state, (T*)out, L, h);
  } else if (d == 32) {
    rwkv6_scan_kernel<T, 32><<<b * h, 32, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, w, u, state, (T*)out, L, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v and out): 0 float32, 1 bfloat16.  d: 32 or 64.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const float* w, const float* u,
                                 float* state, void* out, int dtype, int b,
                                 int L, int h, int d, void* stream) {
  if (b <= 0 || L <= 0 || h <= 0 || (int64_t)b * h > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, state, out, b, L, h, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state, out, b, L, h, d, s);
  return (int)cudaErrorInvalidValue;
}
