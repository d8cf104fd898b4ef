// Row-group soft threshold (the l2,1 prox) on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/l21_prox.py :: l21_prox (Pallas body
//   _l21_kernel), the exact server prox of the l2,1 (joint feature
//   learning) formulation, over a (d, T) iterate:
//     out_i = w_i * max(0, 1 - t / max(||w_i||_2, 1e-12))    for each row i
//
// Bound on the H100: bytes.  One read and one write of d*T elements (8.4 MB
//   at d 8192, T 128 in float32: 2.5 us at 3.35 TB/s) against three
//   operations an element.
//
// Design: a row is reduced by one warp while T is small (eight rows a
//   block of 256 threads) and by one block of 256 threads above kWideT
//   (512) columns.  Where T and the base address allow it, each lane moves 16
//   bytes at a time (4 float32 or 8 bf16), consecutive lanes on
//   consecutive chunks.  The sum of squares is taken in a fixed order:
//   each thread's chunks in turn, then a __shfl_xor_sync butterfly (every
//   lane ends with the same bits, since a + b == b + a), then, for a block
//   row, the warps' sums in warp order through shared memory.  No atomics,
//   so two launches on the same input give the same bits.  The second pass
//   re-reads the row (from L1/L2) and scales it.  The math is float32 with
//   round-to-nearest intrinsics (__fsqrt_rn, __fdiv_rn) whatever nvcc
//   would contract; bf16 loads to float32 and rounds once on the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWideT = 512;   // above this many columns a block takes a row

// float32 elements: 4 to a 16-byte chunk.
struct F32 {
  using S = float;
  static constexpr int kVec = 4;
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float x) { *p = x; }
  __device__ static void unpack(uint4 r, float (&x)[kVec]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&x)[kVec]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};

// bf16 elements as raw 16-bit words: 8 to a 16-byte chunk.  A bf16 value is
// the top half of its float32, so the load is exact.
struct BF16 {
  using S = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float widen(uint32_t bits) {
    return __uint_as_float(bits << 16);
  }
  __device__ static uint32_t narrow(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static float load(const uint16_t* p) { return widen(*p); }
  __device__ static void store(uint16_t* p, float x) {
    *p = static_cast<uint16_t>(narrow(x));
  }
  __device__ static void unpack(uint4 r, float (&x)[kVec]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = widen(w[j] & 0xFFFFu);
      x[2 * j + 1] = widen(w[j] >> 16);
    }
  }
  __device__ static uint4 pack(const float (&x)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = narrow(x[2 * j]) | (narrow(x[2 * j + 1]) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// This thread's share of the row's sum of squares, over its chunks first,
// first + stride, ... in that order.
template <class E, bool kVector>
__device__ float row_sumsq(const typename E::S* row, int T, int first,
                           int stride) {
  float s = 0.f;
  if (kVector) {
    const uint4* chunks = reinterpret_cast<const uint4*>(row);
    for (int c = first; c < T / E::kVec; c += stride) {
      float x[E::kVec];
      E::unpack(chunks[c], x);
#pragma unroll
      for (int j = 0; j < E::kVec; ++j) s = __fmaf_rn(x[j], x[j], s);
    }
  } else {
    for (int c = first; c < T; c += stride) {
      const float x = E::load(row + c);
      s = __fmaf_rn(x, x, s);
    }
  }
  return s;
}

template <class E, bool kVector>
__device__ void row_scale(const typename E::S* row, typename E::S* dst,
                          int T, int first, int stride, float scale) {
  if (kVector) {
    const uint4* chunks = reinterpret_cast<const uint4*>(row);
    uint4* out = reinterpret_cast<uint4*>(dst);
    for (int c = first; c < T / E::kVec; c += stride) {
      float x[E::kVec];
      E::unpack(chunks[c], x);
#pragma unroll
      for (int j = 0; j < E::kVec; ++j) x[j] = __fmul_rn(x[j], scale);
      out[c] = E::pack(x);
    }
  } else {
    for (int c = first; c < T; c += stride) {
      E::store(dst + c, __fmul_rn(E::load(row + c), scale));
    }
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xFFFFFFFFu, s, off));
  }
  return s;
}

// max(0, 1 - t / max(sqrt(sumsq), 1e-12)), rounded as the reference writes it.
__device__ __forceinline__ float shrink(float sumsq, float t) {
  const float norm = fmaxf(__fsqrt_rn(sumsq), 1e-12f);
  return fmaxf(0.f, __fsub_rn(1.f, __fdiv_rn(t, norm)));
}

template <class E, bool kVector>
__global__ void l21_warp_rows(const typename E::S* __restrict__ w,
                              typename E::S* __restrict__ out, float t,
                              int d, int T) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= d) return;                 // uniform over the warp
  const typename E::S* src = w + row * T;
  const float s = warp_sum(row_sumsq<E, kVector>(src, T, lane, 32));
  row_scale<E, kVector>(src, out + row * T, T, lane, 32, shrink(s, t));
}

template <class E, bool kVector>
__global__ void l21_block_rows(const typename E::S* __restrict__ w,
                               typename E::S* __restrict__ out, float t,
                               int T) {
  __shared__ float partial[kWarps];
  const int64_t row = blockIdx.x;
  const typename E::S* src = w + row * T;
  const float s = warp_sum(row_sumsq<E, kVector>(src, T, threadIdx.x,
                                                 kThreads));
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total = __fadd_rn(total, partial[i]);
  row_scale<E, kVector>(src, out + row * T, T, threadIdx.x, kThreads,
                        shrink(total, t));
}

template <class E, bool kVector>
void launch(const void* w, void* out, float t, int d, int T,
            cudaStream_t stream) {
  const auto* src = static_cast<const typename E::S*>(w);
  auto* dst = static_cast<typename E::S*>(out);
  if (T > kWideT) {
    l21_block_rows<E, kVector><<<d, kThreads, 0, stream>>>(src, dst, t, T);
  } else {
    const int blocks = (d + kWarps - 1) / kWarps;
    l21_warp_rows<E, kVector><<<blocks, kThreads, 0, stream>>>(src, dst, t,
                                                               d, T);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  vector: 1 when T is a multiple of the
// 16-byte chunk and w and out are 16-byte aligned.
extern "C" int l21_prox_launch(const void* w, void* out, float t, int d,
                               int T, int dtype, int vector, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d > 0 && T > 0) {
    if (dtype == 0) {
      vector ? launch<F32, true>(w, out, t, d, T, s)
             : launch<F32, false>(w, out, t, d, T, s);
    } else {
      vector ? launch<BF16, true>(w, out, t, d, T, s)
             : launch<BF16, false>(w, out, t, d, T, s);
    }
  }
  return (int)cudaGetLastError();
}
