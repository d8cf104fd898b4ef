// Unmaterialized Gaussian sketch W @ Omega on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gauss_sketch.py :: gauss_sketch (Pallas body
//   _sketch_kernel), the range finder of the randomized SVT.  W is (d, T)
//   float32; Omega (T, p) is never stored in device memory: entry (r, c) is
//   a Box-Muller normal over counter_hash(seed, 2k) and
//   counter_hash(seed, 2k + 1), k = (row_offset + r) * p + c mod 2^32, the
//   reference's exact uint32 hash.
//
// Bound on the H100: bytes, reading W once (4 MB at 8192 x 128); the
//   d*T*p multiply-adds (25 MFLOP at p = 24, 0.75 us at the float32 rate)
//   and the normals are below it, if they are spread over every SM and
//   hidden behind the read.
//
// Design (the launch plan is kernels/gauss_sketch.py :: plan):
//   - block (x, y) owns the output rows [x*ROWS, x*ROWS + ROWS), ROWS =
//     32*R, and the kC = 8 columns [8 y, 8 y + 8), for every p;
//   - a normal costs about 100 instructions (two hashes, a precise logf,
//     cosf and sqrtf) and feeds ROWS fmas, so each block generates only the
//     (T, 8) slice of Omega its columns need, and the plan picks the
//     fattest blocks (R up to 6) that still give about one block to each
//     SM: at d 8192, p 24, 43 x 3 blocks of 192 rows, 1024 normals a block
//     where one block of all 24 columns took 3072.  The price is that each
//     row slab of W is read by ceil(p / 8) blocks, all but one from L2;
//   - W comes in chunks of kChunk = 128 columns, each as kSubs boxes of
//     kSub = 32 columns x ROWS rows: one TMA instruction a box (rows past d
//     and columns past T arrive as zeros), with the 128-byte swizzle, so
//     that the float4 reads below are free of bank conflicts, and each box
//     on its own mbarrier: the product starts on the first box while the
//     others fly.  Meanwhile the block generates the chunk of its Omega
//     slice into shared memory, kGenIlp independent normals a thread at a
//     time.  (Where T % 4 != 0 or W is not 16-byte aligned, which a tensor
//     map cannot describe, cp.async of 4 bytes an element fills the same
//     layout, waited for at once.)  Filling the same layout by 16-byte
//     cp.async, each lane its own quads or the block box by box, measured
//     slower on the H100 (PERF.md's findings);
//   - the product is register-blocked: lane l owns the rows l + 32 r
//     (r < R) and all 8 columns; warp w takes the chunk's column quads w,
//     w + 8, ... (one in each box): for each quad it holds R float4 of W
//     and the quad's four rows of Omega (float4 broadcasts, the same
//     address across the warp) in registers, loaded while the quad before
//     is multiplied, for 32 R fmas, where the first design read both
//     operands from shared memory for every fma;
//   - the eight warps' partial sums meet in shared memory and each output
//     is their sum in warp order: every output element is summed in one
//     fixed order (a thread's t in order, then the warps in order), with
//     no atomics and no cross-block reduction, so two launches agree bit
//     for bit.
//   The hash bits are exact; logf, cosf and sqrtf are CUDA's precise ones
//   (the file is built without --use_fast_math) and may differ from the
//   reference's by an ulp.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kC = 8;                  // columns of Omega a block
constexpr int kSub = 32;               // columns of a box: 128 bytes a row
constexpr int kSubs = 4;               // boxes a chunk
constexpr int kChunk = kSub * kSubs;   // columns of W a chunk
constexpr int kMaxSmem = 232448;
constexpr int kGenIlp = 4;             // normals a thread computes together
static_assert(kSub / 4 == kWarps, "a box holds one quad of each warp");

// Asynchronous copies into shared memory: cp.async of 4 bytes a thread
// (waited for by the issuing thread), and 2-D TMA boxes completing on
// mbarriers, on which every thread waits for the phase.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Waits for every cp.async this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One thread initializes the barrier, before a __syncthreads.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of a phase, which also expects `bytes` of bulk copies
// (they may complete before it: the count of bytes may go below zero).
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later bulk
// copies into the same bytes (the copies run in the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A 2-D box of a tensor map (TMA) into shared memory at `dst`, its bytes
// reported to `bar`; {c0, c1} is the box's first (column, row).
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                           uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ float gauss(uint32_t seed, uint32_t ctr) {
  const uint32_t c2 = ctr * 2u;
  const uint32_t u1 = counter_hash(seed, c2);
  const uint32_t u2 = counter_hash(seed, c2 + 1u);
  const float f1 = __fmul_rn(__fadd_rn((float)(u1 >> 8), 1.0f), 0x1p-24f);
  const float f2 = __fmul_rn((float)(u2 >> 8), 0x1p-24f);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(f1))),
                   cosf(__fmul_rn(6.283185307179586f, f2)));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Shared memory a block of the R kernel takes: a chunk of W (kSubs boxes
// of rows x 128 bytes) and of Omega, or the warps' partials, which reuse
// the same bytes; 1024 more to align the boxes for the swizzle.
// kernels/gauss_sketch.py :: plan computes the same.
__host__ __device__ constexpr int smem_bytes(int rows) {
  return 1024 + 4 * (kChunk * rows + kChunk * kC > kWarps * rows * (kC + 1)
                         ? kChunk * rows + kChunk * kC
                         : kWarps * rows * (kC + 1));
}

// Byte offset of W[row][col] in a chunk: box col / 32, row `row` of 128
// bytes, its 16-byte pieces swizzled by the row (the TMA's 128-byte
// swizzle: piece k of row r lands at piece k ^ (r % 8)).
template <int ROWS>
__device__ __forceinline__ int w_offset(int row, int col) {
  return (col / kSub) * ROWS * 128 + row * 128 +
         ((((col % kSub) / 4) ^ (row % 8)) << 4) + (col % 4) * 4;
}

// Quad q's operands: W[lane + 32 r][4q .. 4q + 3] and Omega's rows
// 4q .. 4q + 3.
template <int R>
struct Quad {
  float4 w[R];
  float4 o[4][kC / 4];

  __device__ __forceinline__ void load(const uint8_t* ws, const float* om,
                                       int lane, int q) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      w[r] = *reinterpret_cast<const float4*>(
          ws + w_offset<32 * R>(lane + 32 * r, 4 * q));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c4 = 0; c4 < kC / 4; ++c4)
        o[i][c4] = *reinterpret_cast<const float4*>(om + (4 * q + i) * kC +
                                                    4 * c4);
  }

  __device__ __forceinline__ void fma_into(float (&acc)[R][kC]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = lane_of(w[r], i);
#pragma unroll
        for (int c4 = 0; c4 < kC / 4; ++c4) {
          acc[r][4 * c4 + 0] = __fmaf_rn(x, o[i][c4].x, acc[r][4 * c4 + 0]);
          acc[r][4 * c4 + 1] = __fmaf_rn(x, o[i][c4].y, acc[r][4 * c4 + 1]);
          acc[r][4 * c4 + 2] = __fmaf_rn(x, o[i][c4].z, acc[r][4 * c4 + 2]);
          acc[r][4 * c4 + 3] = __fmaf_rn(x, o[i][c4].w, acc[r][4 * c4 + 3]);
        }
      }
  }
};

template <int R>
__global__ void __launch_bounds__(kThreads)
gauss_sketch_kernel(const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ w, float* __restrict__ out,
                    uint32_t seed, uint32_t row_offset, int d, int num_t,
                    int p, int vec) {
  constexpr int ROWS = 32 * R;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t box_full[kSubs];   // the boxes' copies
  // the boxes start on a 1024-byte boundary, the swizzle's period
  uint8_t* ws = smem_raw + ((1024u - smem_addr(smem_raw) % 1024u) % 1024u);
  float* om = reinterpret_cast<float*>(ws + kChunk * ROWS * 4);  // (kChunk, kC)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * ROWS, c0 = blockIdx.y * kC;
  const int rows = min(ROWS, d - r0);
  const int cols = min(kC, p - c0);
  if (vec && tid < kSubs) mbar_init(&box_full[tid]);
  __syncthreads();

  float acc[R][kC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.0f;

  uint32_t parity = 0;
  for (int t0 = 0; t0 < num_t; t0 += kChunk) {
    const int tt = min(kChunk, num_t - t0);
    const int tq = (tt + 3) & ~3;      // staged columns: whole quads
    if (vec) {                         // T % 4 == 0, so tq == tt
      if (tid == 0) {
        fence_proxy_async();           // the chunk before is read
        for (int s = 0; s * kSub < tq; ++s) {
          mbar_arrive_expect(&box_full[s], ROWS * kSub * 4);
          tma_load_2d(ws + s * ROWS * 128, &wmap, &box_full[s], t0 + s * kSub,
                      r0);
        }
      }
    } else {                           // past T it is zeros
      for (int e = tid; e < rows * tq; e += kThreads) {
        const int r = e / tq, c = e % tq;
        float* dst = reinterpret_cast<float*>(ws + w_offset<ROWS>(r, c));
        if (c < tt) {
          cp_async4(dst, w + (size_t)(r0 + r) * num_t + t0 + c);
        } else {
          *dst = 0.0f;
        }
      }
    }
    // the chunk's slice of Omega while the copies fly; rows past T and
    // columns past p are 0
    const int n = tq * kC;
    for (int e0 = tid; e0 < n; e0 += kGenIlp * kThreads) {
      float g[kGenIlp];
#pragma unroll
      for (int u = 0; u < kGenIlp; ++u) {
        const int e = min(e0 + u * kThreads, n - 1);
        const int r = e / kC, c = e % kC;
        const float z =
            gauss(seed, (row_offset + (uint32_t)(t0 + r)) * (uint32_t)p +
                            (uint32_t)(c0 + c));
        g[u] = (r < tt && c < cols) ? z : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kGenIlp; ++u)
        if (e0 + u * kThreads < n) om[e0 + u * kThreads] = g[u];
    }
    if (!vec) cp_async_wait_all();
    __syncthreads();

    // Warp w's quads w, w + 8, ...: quad q lies in box q / 8, whose copy it
    // waits for; each quad's operands are loaded (into the other of two
    // buffers) while the quad before is multiplied.
    const int nq = tq / 4;
    auto load = [&](Quad<R>& x, int q) {
      if (vec) mbar_wait(&box_full[q / kWarps], parity);
      x.load(ws, om, lane, q);
    };
    if (warp < nq) {
      Quad<R> a, b;
      load(a, warp);
      for (int q = warp;; q += 2 * kWarps) {
        if (q + kWarps < nq) load(b, q + kWarps);
        a.fma_into(acc);
        if (q + kWarps >= nq) break;
        if (q + 2 * kWarps < nq) load(a, q + 2 * kWarps);
        b.fma_into(acc);
        if (q + 2 * kWarps >= nq) break;
      }
    }
    parity ^= 1u;
    __syncthreads();   // the staging is read; the next chunk overwrites it
  }

  // The warps' partials, summed in warp order.  Row stride kC + 1 (odd): a
  // warp's 32 rows of one column fall in 32 banks.
  float* red = reinterpret_cast<float*>(ws);   // (kWarps, ROWS, kC + 1)
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      red[(warp * ROWS + lane + 32 * r) * (kC + 1) + c] = acc[r][c];
  __syncthreads();
  for (int e = tid; e < rows * kC; e += kThreads) {
    const int r = e / kC, c = e % kC;
    if (c >= cols) continue;
    float sum = red[r * (kC + 1) + c];
#pragma unroll
    for (int k = 1; k < kWarps; ++k)
      sum = __fadd_rn(sum, red[(k * ROWS + r) * (kC + 1) + c]);
    out[(size_t)(r0 + r) * p + c0 + c] = sum;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its entry
// point, so the kernel library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)ptr;
  }
  return fn;
}

// W (d, T) float32 as boxes of kSub columns x `rows` rows, 128-byte swizzle.
bool make_map(CUtensorMap* map, const float* w, int d, int num_t, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)num_t, (cuuint64_t)d};
  const cuuint64_t strides[1] = {(cuuint64_t)num_t * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kSub, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R>
int launch(const float* w, float* out, uint32_t seed, uint32_t row_offset,
           int d, int num_t, int p, int grid_x, int grid_y, int smem, int vec,
           cudaStream_t stream) {
  if (smem != smem_bytes(32 * R) || (long long)grid_x * 32 * R < d ||
      (long long)grid_y * kC < p)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (vec && !make_map(&map, w, d, num_t, 32 * R))
    return (int)cudaErrorInvalidValue;
  static int opted_in = 48 * 1024;     // this instance's dynamic smem limit
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        gauss_sketch_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  gauss_sketch_kernel<R><<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(
      map, w, out, seed, row_offset, d, num_t, p, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's fields: rows_per_thread R (1, 2, 3 or 6), the grid and the
// dynamic shared bytes; `vec` says that T % 4 == 0 and W is 16-byte
// aligned (a tensor map of W, TMA boxes).
extern "C" int gauss_sketch_launch(const float* w, float* out, unsigned seed,
                                   unsigned row_offset, int d, int num_t,
                                   int p, int rows_per_thread, int grid_x,
                                   int grid_y, int smem, int vec,
                                   void* stream) {
  if (p < 1 || smem > kMaxSmem ||
      (vec && (num_t % 4 != 0 || (uintptr_t)w % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (grid_x == 0 || grid_y == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (rows_per_thread) {
#define GAUSS_SKETCH_CASE(R)                                                 \
  case R:                                                                    \
    return launch<R>(w, out, seed, row_offset, d, num_t, p, grid_x, grid_y, \
                     smem, vec, st);
    GAUSS_SKETCH_CASE(1)
    GAUSS_SKETCH_CASE(2)
    GAUSS_SKETCH_CASE(3)
    GAUSS_SKETCH_CASE(6)
#undef GAUSS_SKETCH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
