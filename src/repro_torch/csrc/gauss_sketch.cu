// Unmaterialized Gaussian sketch W @ Omega on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gauss_sketch.py :: gauss_sketch (Pallas body
//   _sketch_kernel), the range finder of the randomized SVT.  W is (d, T)
//   float32; Omega (T, p) is never stored: entry (r, c) is a Box-Muller
//   normal over counter_hash(seed, 2k) and counter_hash(seed, 2k + 1),
//   k = (row_offset + r) * p + c, the reference's exact uint32 hash.
//
// Bound on the H100: bytes, reading W once (4 MB at 8192 x 128); the
//   d*T*p multiply-adds (25 MFLOP at p = 24) and the normals are far below
//   the card's float32 rate.
//
// Design: a block owns ROWS rows of the output and loops over T in tiles
//   of TILE_T: it stages the (ROWS, TILE_T) tile of W in shared memory,
//   generates the (TILE_T, p) tile of Omega there from the hash, and each
//   thread accumulates its fixed set of output elements in registers.
//   Each block owns its output rows, so there is no cross-block reduction.
//   Every block regenerates Omega (T*p normals, a few thousand), which is
//   cheaper than a pass through device memory.  The hash bits are exact;
//   logf, cosf and sqrtf are CUDA's (the file is built without
//   --use_fast_math) and may differ from the reference's by an ulp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileT = 32;
constexpr int kMaxP = 256;
constexpr int kMaxAcc = 8;                  // outputs held per thread
constexpr int kMaxRows = 32;

__device__ __forceinline__ float gauss(uint32_t seed, uint32_t ctr) {
  const uint32_t c2 = ctr * 2u;
  const uint32_t u1 = counter_hash(seed, c2);
  const uint32_t u2 = counter_hash(seed, c2 + 1u);
  const float f1 = __fmul_rn(__fadd_rn((float)(u1 >> 8), 1.0f), 0x1p-24f);
  const float f2 = __fmul_rn((float)(u2 >> 8), 0x1p-24f);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(f1))),
                   cosf(__fmul_rn(6.283185307179586f, f2)));
}

__global__ void __launch_bounds__(kThreads)
gauss_sketch_kernel(const float* __restrict__ w, float* __restrict__ out,
                    uint32_t seed, int row_offset, int d, int num_t, int p,
                    int rows) {
  __shared__ float ws[kMaxRows][kTileT + 1];
  __shared__ float om[kTileT][kMaxP];
  const int r0 = blockIdx.x * rows;
  const int n_out = rows * p;
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.0f;

  for (int t0 = 0; t0 < num_t; t0 += kTileT) {
    const int tt = min(kTileT, num_t - t0);
    for (int e = threadIdx.x; e < rows * kTileT; e += blockDim.x) {
      const int rr = e / kTileT, c = e % kTileT, row = r0 + rr;
      ws[rr][c] = (row < d && c < tt) ? w[(size_t)row * num_t + t0 + c] : 0.0f;
    }
    for (int e = threadIdx.x; e < tt * p; e += blockDim.x) {
      const int rr = e / p, c = e % p;
      const uint32_t ctr =
          (uint32_t)(row_offset + t0 + rr) * (uint32_t)p + (uint32_t)c;
      om[rr][c] = gauss(seed, ctr);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int o = threadIdx.x + k * blockDim.x;
      if (o < n_out) {
        const int rr = o / p, c = o % p;
        float a = acc[k];
        for (int j = 0; j < tt; ++j) a = __fmaf_rn(ws[rr][j], om[j][c], a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int o = threadIdx.x + k * blockDim.x;
    if (o < n_out) {
      const int row = r0 + o / p;
      if (row < d) out[(size_t)row * p + o % p] = acc[k];
    }
  }
}

}  // namespace

extern "C" int gauss_sketch_launch(const float* w, float* out, unsigned seed,
                                   int row_offset, int d, int num_t, int p,
                                   void* stream) {
  if (p < 1 || p > kMaxP) return (int)cudaErrorInvalidValue;
  int rows = (kThreads * kMaxAcc) / p;
  if (rows > kMaxRows) rows = kMaxRows;
  const int blocks = (d + rows - 1) / rows;
  if (blocks > 0) {
    gauss_sketch_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        w, out, (uint32_t)seed, row_offset, d, num_t, p, rows);
  }
  return (int)cudaGetLastError();
}
