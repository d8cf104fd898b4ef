// The KM update (paper Eq. III.4) and its strided column form, shared by
// every kernel that applies it (amtl_event.cu, km_update.cu), so the
// update's rounding and the in-place column walk live in one place.
//
// km_fma is the update written as the two fused multiply-adds XLA's CPU
// backend emits for the reference expression v + eta_k * (p - eta*g - v):
//     fma(eta_k, fma(-eta, g, p) - v, v)
// with explicit round-to-nearest intrinsics, so the result is bitwise the
// reference's and the plain PyTorch version's, whatever nvcc would
// contract on its own.
//
// km_column_row does one row of a column given by pointer and element
// stride: it reads the source word (as raw bits), p[i] and g[i] before any
// store, writes the update into the destination and, where kUndo, the
// source's bits into old[i].  Source and destination may be one column
// (in place): each row reads its own word before it writes it, so neither
// pointer is __restrict__.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ float km_fma(float v, float p, float g, float eta,
                                        float eta_k) {
  return __fmaf_rn(eta_k, __fsub_rn(__fmaf_rn(-eta, g, p), v), v);
}

template <bool kUndo>
__device__ __forceinline__ void km_column_row(
    const uint32_t* src, int64_t src_stride, float* dst, int64_t dst_stride,
    uint32_t* __restrict__ old, const float* __restrict__ p,
    const float* __restrict__ g, float eta, float eta_k, int i) {
  const uint32_t bits = src[(int64_t)i * src_stride];
  const float pi = __ldg(p + i);
  const float gi = __ldg(g + i);
  if (kUndo) old[i] = bits;
  dst[(int64_t)i * dst_stride] = km_fma(__uint_as_float(bits), pi, gi, eta,
                                        eta_k);
}

}  // namespace
