// Thresholded low-rank SVT apply (QU * sigma) @ V^T on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/svt_reconstruct.py :: svt_reconstruct
//   (Pallas body _kernel), the tail of the randomized SVT: QU (d, p),
//   sigma (p,), V^T (p, m), all float32, out (d, m).
//
// Bound on the H100: bytes, writing the (d, m) output (4 MB at
//   8192 x 128); the rank-p product is 2*d*p*m = 50 MFLOP at p = 24, 0.75
//   us at the float32 rate, so each output element should cost a few
//   register fmas and no shared-memory read of its own.
//
// Design (the launch plan is kernels/svt_reconstruct.py :: plan):
//   - block (x, y) owns the output rows [x*rows_b, x*rows_b + rows_b) and
//     the 128 columns [128 y, 128 y + 128); the plan sizes rows_b so that
//     about one block runs on each SM (128 blocks of 64 rows at d 8192,
//     m 128), and the column tiles take any m;
//   - p is taken in chunks of PC (one chunk at p <= 32): the block stages
//     the chunk of V^T's column tile (PC x 128), of its rows of QU and of
//     sigma in shared memory, once per block, by cp.async (16 bytes a copy
//     where the shapes and pointers allow, else 4), so that every copy of a
//     thread is in flight at once (a load into a register and a store would
//     wait for one L2 round trip each); QU's chunk is then scaled by sigma
//     in place (the TPU kernel fuses the scale into its operand load the
//     same way, so no (d, p) scaled temporary exists in device memory);
//   - lane l owns the four output columns 4l..4l+3 of the tile and copies
//     V^T[chunk, 4l..4l+3] into registers (4 PC values); warp w walks the
//     rows w, w + 8, ..., four at a time (16 independent sums): for each
//     row it reads the row's PC scaled values of QU as float4 broadcasts,
//     does 4 PC fmas and writes one float4, so a warp writes 512 contiguous
//     bytes a row, where the first design read both operands from shared
//     memory for every fma;
//   - with more than one chunk a thread adds the next chunk's terms to the
//     sums it wrote for the same four elements: each output element is a
//     sum over p in order inside one thread, with no atomics, so two
//     launches agree bit for bit.
//   The product is done here, not by cuBLAS, as the TPU kernel does it in
//   its own body.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColTile = 128;          // 32 lanes x 4 columns
constexpr int kStep = 4;               // rows a warp multiplies together
constexpr int kMaxSmem = 232448;

// cp.async of 4 or 16 bytes a thread, waited for by the issuing thread
// and made visible to the block by a barrier.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Waits for every cp.async this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Shared memory of a block: V^T's chunk of the column tile, the chunk of
// its QU rows and of sigma.  kernels/svt_reconstruct.py :: plan computes
// the same.
__host__ __device__ constexpr int smem_bytes(int pc, int rows_b) {
  return 4 * (pc * kColTile + rows_b * pc + pc);
}

template <int PC>
__global__ void __launch_bounds__(kThreads)
svt_reconstruct_kernel(const float* __restrict__ qu,
                       const float* __restrict__ s,
                       const float* __restrict__ vt, float* __restrict__ out,
                       int d, int p, int m, int rows_b, int vec_cols,
                       int vec_rows) {
  extern __shared__ __align__(16) float smem[];
  float* vts = smem;                   // (PC, kColTile)
  float* qs = smem + PC * kColTile;    // (rows_b, PC), scaled by sigma
  float* ss = qs + rows_b * PC;        // (PC,) sigma
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * rows_b, c0 = blockIdx.y * kColTile;
  const int rows = min(rows_b, d - r0);
  const int cols = min(kColTile, m - c0);
  const int col = 4 * lane;            // this lane's first column of the tile

  for (int k0 = 0; k0 < p; k0 += PC) {
    const int kk = min(PC, p - k0);
    if (k0 > 0) __syncthreads();       // every warp is done with the chunk
    // the chunk's operands; past p and past m they are zeros
    if (vec_cols) {                    // 16-byte copies: m % 4 == 0
      for (int e = tid; e < PC * kColTile / 4; e += kThreads) {
        const int k = e / (kColTile / 4), c = 4 * (e % (kColTile / 4));
        float* dst = vts + k * kColTile + c;
        if (k < kk && c < cols) {
          cp_async16(dst, vt + (size_t)(k0 + k) * m + c0 + c);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      for (int e = tid; e < PC * kColTile; e += kThreads) {
        const int k = e / kColTile, c = e % kColTile;
        if (k < kk && c < cols) {
          cp_async4(vts + e, vt + (size_t)(k0 + k) * m + c0 + c);
        } else {
          vts[e] = 0.0f;
        }
      }
    }
    if (vec_rows) {                    // 16-byte copies: p % 4 == 0
      for (int e = tid; e < rows * PC / 4; e += kThreads) {
        const int r = e / (PC / 4), k = 4 * (e % (PC / 4));
        if (k < kk) {
          cp_async16(qs + r * PC + k, qu + (size_t)(r0 + r) * p + k0 + k);
        } else {
          *reinterpret_cast<float4*>(qs + r * PC + k) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      for (int e = tid; e < rows * PC; e += kThreads) {
        const int r = e / PC, k = e % PC;
        if (k < kk) {
          cp_async4(qs + e, qu + (size_t)(r0 + r) * p + k0 + k);
        } else {
          qs[e] = 0.0f;
        }
      }
    }
    if (tid < PC) {
      if (tid < kk) {
        cp_async4(ss + tid, s + k0 + tid);
      } else {
        ss[tid] = 0.0f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    for (int e = tid; e < rows * PC; e += kThreads)   // QU * sigma, in place
      qs[e] = __fmul_rn(qs[e], ss[e % PC]);
    __syncthreads();

    float v[PC][4];
#pragma unroll
    for (int k = 0; k < PC; ++k) {
      const float4 x =
          *reinterpret_cast<const float4*>(vts + k * kColTile + col);
      v[k][0] = x.x;
      v[k][1] = x.y;
      v[k][2] = x.z;
      v[k][3] = x.w;
    }
    // kStep rows at a time, r, r + 8, ... (16 independent sums a lane)
    for (int r = warp; r < rows; r += kStep * kWarps) {
      int rr[kStep];
      float acc[kStep][4];
#pragma unroll
      for (int h = 0; h < kStep; ++h) {
        rr[h] = r + h * kWarps < rows ? r + h * kWarps : r;  // a copy of r
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[h][j] = 0.0f;
        if (k0 > 0) {                  // its sums of the chunks before
          const float* src = out + (size_t)(r0 + rr[h]) * m + c0 + col;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < cols) acc[h][j] = src[j];
        }
      }
#pragma unroll
      for (int k4 = 0; k4 < PC / 4; ++k4) {
#pragma unroll
        for (int h = 0; h < kStep; ++h) {
          const float4 q =
              *reinterpret_cast<const float4*>(qs + rr[h] * PC + 4 * k4);
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[h][j] = __fmaf_rn(qv[i], v[4 * k4 + i][j], acc[h][j]);
        }
      }
#pragma unroll
      for (int h = 0; h < kStep; ++h) {
        if (h > 0 && rr[h] == r) break;    // past the block's rows
        float* dst = out + (size_t)(r0 + rr[h]) * m + c0 + col;
        if (vec_cols && col + 3 < cols) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < cols) dst[j] = acc[h][j];
        }
      }
    }
  }
}

template <int PC>
int launch(const float* qu, const float* s, const float* vt, float* out,
           int d, int p, int m, int rows_b, int grid_x, int grid_y, int smem,
           int vec_cols, int vec_rows, cudaStream_t stream) {
  if (smem != smem_bytes(PC, rows_b) || rows_b < 1 ||
      (long long)grid_x * rows_b < d || (long long)grid_y * kColTile < m)
    return (int)cudaErrorInvalidValue;
  static int opted_in = 48 * 1024;     // this instance's dynamic smem limit
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        svt_reconstruct_kernel<PC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  svt_reconstruct_kernel<PC><<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(
      qu, s, vt, out, d, p, m, rows_b, vec_cols, vec_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's fields: the p chunk PC (4, 8, 16, 24 or 32), rows a block,
// the grid and the dynamic shared bytes.  `vec_cols`: m % 4 == 0 and V^T
// and out are 16-byte aligned (16-byte copies of V^T, float4 stores);
// `vec_rows`: p % 4 == 0 and QU is 16-byte aligned (16-byte copies of QU).
extern "C" int svt_reconstruct_launch(const float* qu, const float* s,
                                      const float* vt, float* out, int d,
                                      int p, int m, int p_chunk, int rows_b,
                                      int grid_x, int grid_y, int smem,
                                      int vec_cols, int vec_rows,
                                      void* stream) {
  if (p < 1 || smem > kMaxSmem || (vec_cols && m % 4 != 0) ||
      (vec_rows && p % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (grid_x == 0 || grid_y == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (p_chunk) {
#define SVT_RECONSTRUCT_CASE(PC)                                            \
  case PC:                                                                  \
    return launch<PC>(qu, s, vt, out, d, p, m, rows_b, grid_x, grid_y, smem, \
                      vec_cols, vec_rows, st);
    SVT_RECONSTRUCT_CASE(4)
    SVT_RECONSTRUCT_CASE(8)
    SVT_RECONSTRUCT_CASE(16)
    SVT_RECONSTRUCT_CASE(24)
    SVT_RECONSTRUCT_CASE(32)
#undef SVT_RECONSTRUCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
