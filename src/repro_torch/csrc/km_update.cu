// Fused AMTL/KM block update on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/km_update.py :: km_update (Pallas body
//   _km_kernel), the dense engine's per-event update of the activated
//   task's block (paper Eq. III.4), elementwise:
//     out = v + eta_k * (p - eta*g - v)
//
// Bound on the H100: bytes.  Three reads and one write of n elements (16.8
//   MB at (8192, 128) in float32: 5.0 us at 3.35 TB/s); the dense engine's
//   one (8192,) column an event moves 131 KB, so one launch there sits at
//   launch latency, as amtl_event does.
//
// Design: one thread an element, consecutive threads on consecutive
//   addresses, over any contiguous shape.  The update is the two fused
//   multiply-adds of csrc/amtl_event.cu, fma(eta_k, fma(-eta, g, p) - v, v),
//   with explicit round-to-nearest intrinsics, so the result is bitwise the
//   plain version's (and the delta engine's column event), whatever nvcc
//   would contract on its own.  bf16 loads to float32, does the same fmas
//   and rounds once on the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename S>
__global__ void km_update_kernel(const S* __restrict__ v,
                                 const S* __restrict__ p,
                                 const S* __restrict__ g, float eta,
                                 float eta_k, S* __restrict__ out,
                                 int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float vi = load(v + i);
  const float a = __fmaf_rn(-eta, load(g + i), load(p + i));
  store(out + i, __fmaf_rn(eta_k, __fsub_rn(a, vi), vi));
}

template <typename S>
void launch(const void* v, const void* p, const void* g, float eta,
            float eta_k, void* out, int64_t n, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  km_update_kernel<S><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const S*>(v), static_cast<const S*>(p),
      static_cast<const S*>(g), eta, eta_k, static_cast<S*>(out), n);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (v, p, g and out alike).
extern "C" int km_update_launch(const void* v, const void* p, const void* g,
                                float eta, float eta_k, void* out, int64_t n,
                                int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (dtype == 0) {
      launch<float>(v, p, g, eta, eta_k, out, n, s);
    } else {
      launch<__nv_bfloat16>(v, p, g, eta, eta_k, out, n, s);
    }
  }
  return (int)cudaGetLastError();
}
