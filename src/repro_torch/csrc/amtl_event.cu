// Fused AMTL delta-ring column event on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/amtl_event.py :: amtl_event (Pallas body
//   _amtl_event_kernel), the delta engine's per-event column update:
//     v_new = v + eta_k * (p - eta*g - v)     (Eq. III.4)
//     old   = v                               (undo-log entry, exact bits)
//   together with the reference's `v.at[:, t].set(v_new)` and
//   `delta_ring.at[ptr].set(old)` (src/repro/core/amtl.py:488-496), which
//   XLA fuses into the same step.
//
// Bound on the H100: bytes, and at the engine's widths the launch.  The
//   function moves 3 reads and 2 writes of d floats (164 KB at d = 8192,
//   0.05 us at 3.35 TB/s); on the engine's state each word of V's column
//   lies in its own 32-byte sector (a row of V is T * 4 = 512 bytes), so
//   the sectors touched are ~0.62 MB, 0.19 us.  Either is far under the
//   ~2.2 us a near-empty launch takes, so the design's answer is one
//   launch where the engine made four (a strided gather of the column,
//   this kernel, a strided scatter back, the ring slot copy).
//
// Design: one row a thread, 64 threads a block, so d = 8192 spreads over
//   128 blocks and every SM holds some; each thread issues its three loads
//   before either store and reads nothing twice.  The source and the
//   destination column are given by pointer and element stride: stride 1
//   into fresh outputs for the contiguous call, or V's column t at stride
//   T, updated in place, with the undo entry written straight into the
//   ring slot.  Each row is `km_column_row` of km_column.cuh: the update
//   as the two fused multiply-adds of the reference expression, bitwise
//   the reference's and the plain PyTorch version's, and `old` copied as
//   raw 32-bit words.
#include <cuda_runtime.h>
#include <stdint.h>

#include "km_column.cuh"

namespace {

constexpr int kThreads = 64;

// src and dst may be the same column (the in-place call).
__global__ void amtl_event_kernel(const uint32_t* src, int64_t src_stride,
                                  float* dst, int64_t dst_stride,
                                  uint32_t* __restrict__ old,
                                  const float* __restrict__ p,
                                  const float* __restrict__ g, float eta,
                                  float eta_k, int d) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < d) {
    km_column_row<true>(src, src_stride, dst, dst_stride, old, p, g, eta,
                        eta_k, i);
  }
}

int launch(const void* src, int64_t src_stride, float* dst,
           int64_t dst_stride, void* old, const float* p, const float* g,
           float eta, float eta_k, int d, void* stream) {
  const int blocks = (d + kThreads - 1) / kThreads;
  if (blocks > 0) {
    amtl_event_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(src), src_stride, dst, dst_stride,
        static_cast<uint32_t*>(old), p, g, eta, eta_k, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Contiguous (d,) columns into fresh outputs v_new and old.
extern "C" int amtl_event_launch(const float* v, const float* p,
                                 const float* g, float eta, float eta_k,
                                 float* v_new, float* old, int d,
                                 void* stream) {
  return launch(v, 1, v_new, 1, old, p, g, eta, eta_k, d, stream);
}

// The engine's state: column t of the contiguous (d, T) iterate v updated
// in place, its pre-write bits into the contiguous (d,) ring slot `old`.
extern "C" int amtl_event_inplace_launch(float* v, int t, int num_t,
                                         const float* p, const float* g,
                                         float eta, float eta_k, float* old,
                                         int d, void* stream) {
  float* col = v + t;
  return launch(col, num_t, col, num_t, old, p, g, eta, eta_k, d, stream);
}
