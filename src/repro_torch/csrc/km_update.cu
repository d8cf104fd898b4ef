// Fused AMTL/KM block update on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/km_update.py :: km_update (Pallas body
//   _km_kernel), the dense engine's per-event update of the activated
//   task's block (paper Eq. III.4), elementwise:
//     out = v + eta_k * (p - eta*g - v)
//   Two entry points: the contiguous update over any shape (float32 or
//   bf16), and the dense engine's slot update, which also does the
//   reference's `v_cur.at[:, t].set(...)` and `ring.at[ptr].set(v_new)`
//   (src/repro/core/amtl.py:428-434): ring[dst] is written whole from
//   ring[src], column t updated on the way.
//
// Bound on the H100: bytes.  The contiguous update: three reads and one
//   write of n elements (16.8 MB at (8192, 128) in float32: 5.0 us at
//   3.35 TB/s).  The slot update: a (d, T) slot read and one written, plus
//   p_t and g_t (8.45 MB at d 8192, T 128: 2.52 us); with src = dst
//   (tau 0, a ring of one slot) only column t is read and written, which
//   sits at launch latency, as amtl_event does.
//
// Design: the contiguous update takes one thread an element, consecutive
//   threads on consecutive addresses.  The slot update takes 16-byte
//   vectors along the rows, two a thread, 256 threads a block (512
//   blocks of 8 KB at (8192, 128): every SM holds some, each thread has
//   both loads in flight before its first store); the lane whose vector
//   holds column t loads that row's p and g with the vector and applies
//   the update to that one element.  Where T % 4 != 0 or the ring is not
//   16-byte aligned the same kernel runs on single words.  (At (9, 8192,
//   128) on an H100 four or one vectors a thread, 128 or 512 threads a
//   block, streaming stores and a shift in place of the row division all
//   came within 0.3 us of this.  The evict-first hint on the source
//   saved 0.2 us L2-cold alone, but the dense l21 session's device time
//   was level with and without it, and later events read the ring again
//   from L2, so the loads are plain.)  With src = dst the slot kernel
//   would copy a slot onto itself through __restrict__ operands, so that
//   case is its own small kernel: the strided column walk of
//   km_column.cuh, which amtl_event.cu runs too, without the undo write.
//   Every update is km_fma of km_column.cuh, the two fused multiply-adds
//   with explicit round-to-nearest intrinsics, so the result is bitwise
//   the plain version's (and the delta engine's column event), whatever
//   nvcc would contract on its own; every other element is copied as its
//   raw bits.  bf16 (the contiguous update only) loads to float32, does
//   the same fmas and rounds once on the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "km_column.cuh"

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
  store(out + i, km_fma(load(v + i), load(p + i), load(g + i), eta, eta_k));
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


// The update on element k of a unit, by name, so the unit stays in
// registers (an index into it would put it in local memory).
__device__ __forceinline__ void update_lane(float& x, int k, float p, float g,
                                            float eta, float eta_k) {
  if (k == 0) x = km_fma(x, p, g, eta, eta_k);
}
__device__ __forceinline__ void update_lane(float4& x, int k, float p,
                                            float g, float eta, float eta_k) {
  if (k == 0) {
    x.x = km_fma(x.x, p, g, eta, eta_k);
  } else if (k == 1) {
    x.y = km_fma(x.y, p, g, eta, eta_k);
  } else if (k == 2) {
    x.z = km_fma(x.z, p, g, eta, eta_k);
  } else if (k == 3) {
    x.w = km_fma(x.w, p, g, eta, eta_k);
  }
}

constexpr int kSlotThreads = 256;
constexpr int kSlotUnroll = 2;

// ring[dst] = ring[src] with column t updated, as kSlotUnroll words or
// 16-byte vectors (W = 1 or 4 floats) a thread.  n is the slot's number of
// W-wide units and row_units a row's (T / W); src != dst.
template <typename V, int W>
__global__ void __launch_bounds__(kSlotThreads)
km_slot_kernel(const V* __restrict__ src, V* __restrict__ dst,
               const float* __restrict__ p, const float* __restrict__ g,
               float eta, float eta_k, uint32_t t, uint32_t row_units,
               uint32_t n) {
  const uint32_t base = blockIdx.x * (kSlotThreads * kSlotUnroll)
                        + threadIdx.x;
  V x[kSlotUnroll];
  float pu[kSlotUnroll], gu[kSlotUnroll];
  int lane[kSlotUnroll];
#pragma unroll
  for (int u = 0; u < kSlotUnroll; ++u) {
    const uint32_t q = base + u * kSlotThreads;
    lane[u] = -1;
    if (q < n) {
      x[u] = __ldg(src + q);
      const uint32_t row = q / row_units;
      const int k = (int)(t - (q - row * row_units) * W);
      if (k >= 0 && k < W) {
        lane[u] = k;
        pu[u] = __ldg(p + row);
        gu[u] = __ldg(g + row);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kSlotUnroll; ++u) {
    const uint32_t q = base + u * kSlotThreads;
    if (q >= n) continue;
    if (lane[u] >= 0) update_lane(x[u], lane[u], pu[u], gu[u], eta, eta_k);
    dst[q] = x[u];
  }
}

// Column t of a (d, T) slot updated in place (src = dst).
__global__ void km_column_kernel(float* col, int64_t stride,
                                 const float* __restrict__ p,
                                 const float* __restrict__ g, float eta,
                                 float eta_k, int d) {
  const int i = blockIdx.x * 64 + threadIdx.x;
  if (i < d) {
    km_column_row<false>(reinterpret_cast<const uint32_t*>(col), stride, col,
                         stride, nullptr, p, g, eta, eta_k, i);
  }
}

template <typename V, int W>
void launch_slot(const float* src, float* dst, const float* p,
                 const float* g, float eta, float eta_k, int t, int num_t,
                 int d, cudaStream_t stream) {
  const uint32_t n = (uint32_t)((int64_t)d * num_t / W);
  const uint32_t per_block = kSlotThreads * kSlotUnroll;
  const uint32_t blocks = (n + per_block - 1) / per_block;
  km_slot_kernel<V, W><<<blocks, kSlotThreads, 0, stream>>>(
      reinterpret_cast<const V*>(src), reinterpret_cast<V*>(dst), p, g, eta,
      eta_k, (uint32_t)t, (uint32_t)(num_t / W), n);
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

// The dense engine's slot update on a contiguous (depth, d, T) float32
// ring: ring[dst] written whole from ring[src] with column t updated, or
// column t alone in place where src == dst.  `vector` takes 16-byte
// vectors (T % 4 == 0 and the ring 16-byte aligned, which the caller
// checks); d * T < 2^31.
extern "C" int km_update_slot_launch(float* ring, int src, int dst, int t,
                                     int d, int num_t, const float* p,
                                     const float* g, float eta, float eta_k,
                                     int vector, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t slot = (int64_t)d * num_t;
  if (slot > 0) {
    const float* from = ring + src * slot;
    float* to = ring + dst * slot;
    if (src == dst) {
      km_column_kernel<<<(d + 63) / 64, 64, 0, s>>>(to + t, num_t, p, g, eta,
                                                     eta_k, d);
    } else if (vector) {
      launch_slot<float4, 4>(from, to, p, g, eta, eta_k, t, num_t, d, s);
    } else {
      launch_slot<float, 1>(from, to, p, g, eta, eta_k, t, num_t, d, s);
    }
  }
  return (int)cudaGetLastError();
}
