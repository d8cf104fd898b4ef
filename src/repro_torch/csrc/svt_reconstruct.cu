// Thresholded low-rank SVT apply (QU * sigma) @ V^T on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/svt_reconstruct.py :: svt_reconstruct
//   (Pallas body _kernel), the tail of the randomized SVT: QU (d, p),
//   sigma (p,), V^T (p, m), all float32, out (d, m).
//
// Bound on the H100: bytes, writing the (d, m) output (4 MB at
//   8192 x 128; the rank-p product is 2*d*p*m = 50 MFLOP at p = 24).
//
// Design: each block owns kRows output rows and stages in shared memory
//   the whole (p, m) V^T (12 KB at p = 24, m = 128) and its kRows rows of
//   QU, scaled by sigma as they are loaded (the TPU kernel fuses the scale
//   into its operand load the same way), so no (d, p) scaled temporary
//   exists in device memory and each QU element is read once.  Thread and
//   element are matched so that consecutive threads write consecutive
//   columns of a row (coalesced) and read the same scaled QU element (a
//   shared-memory broadcast).  Each output element is a loop over p.  The
//   product is done here, not by cuBLAS, as the TPU kernel does it in its
//   own body.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
svt_reconstruct_kernel(const float* __restrict__ qu,
                       const float* __restrict__ s,
                       const float* __restrict__ vt, float* __restrict__ out,
                       int d, int p, int m) {
  extern __shared__ float smem[];
  float* vts = smem;                        // (p, m)
  float* qs = smem + p * m;                 // (kRows, p), scaled by sigma
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, d - r0);
  for (int e = threadIdx.x; e < p * m; e += blockDim.x) vts[e] = vt[e];
  for (int e = threadIdx.x; e < rows * p; e += blockDim.x) {
    qs[e] = __fmul_rn(qu[(size_t)r0 * p + e], s[e % p]);
  }
  __syncthreads();
  const int n_out = rows * m;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int rr = o / m, c = o % m;
    const float* qrow = qs + rr * p;
    float acc = 0.0f;
    for (int k = 0; k < p; ++k) acc = __fmaf_rn(qrow[k], vts[k * m + c], acc);
    out[(size_t)(r0 + rr) * m + c] = acc;
  }
}

}  // namespace

extern "C" int svt_reconstruct_launch(const float* qu, const float* s,
                                      const float* vt, float* out, int d,
                                      int p, int m, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)p * m + (size_t)kRows * p);
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        svt_reconstruct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (d + kRows - 1) / kRows;
  if (blocks > 0 && m > 0) {
    svt_reconstruct_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        qu, s, vt, out, d, p, m);
  }
  return (int)cudaGetLastError();
}
