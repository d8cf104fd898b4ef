// Fused AMTL delta-ring column event on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/amtl_event.py :: amtl_event (Pallas body
//   _amtl_event_kernel), the delta engine's per-event column update:
//     v_new = v + eta_k * (p - eta*g - v)     (Eq. III.4)
//     old   = v                               (undo-log entry, exact bits)
//
// Bound on the H100: bytes.  3 reads and 2 writes of d floats (160 KB at
//   d = 8192) against no reuse, so at the engine's widths one launch sits
//   near launch latency rather than the 3.35 TB/s memory rate.
//
// Design: one thread per element, consecutive threads on consecutive
//   addresses (coalesced).  The update is written as the two fused
//   multiply-adds XLA's CPU backend emits for the reference expression,
//   fma(eta_k, fma(-eta, g, p) - v, v), with explicit round-to-nearest
//   intrinsics, so the result is bitwise the reference's and the plain
//   PyTorch version's, whatever nvcc would contract on its own.  `old` is
//   copied as raw 32-bit words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void amtl_event_kernel(const float* __restrict__ v,
                                  const float* __restrict__ p,
                                  const float* __restrict__ g,
                                  float eta, float eta_k,
                                  float* __restrict__ v_new,
                                  uint32_t* __restrict__ old, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  const uint32_t bits = reinterpret_cast<const uint32_t*>(v)[i];
  old[i] = bits;
  const float vi = __uint_as_float(bits);
  const float a = __fmaf_rn(-eta, g[i], p[i]);
  v_new[i] = __fmaf_rn(eta_k, __fsub_rn(a, vi), vi);
}

}  // namespace

extern "C" int amtl_event_launch(const float* v, const float* p,
                                 const float* g, float eta, float eta_k,
                                 float* v_new, float* old, int d,
                                 void* stream) {
  const int threads = 256;
  const int blocks = (d + threads - 1) / threads;
  if (blocks > 0) {
    amtl_event_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        v, p, g, eta, eta_k, v_new, reinterpret_cast<uint32_t*>(old), d);
  }
  return (int)cudaGetLastError();
}
