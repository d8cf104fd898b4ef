// Fused least-squares task gradient on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lstsq_grad.py :: lstsq_grad (Pallas bodies
//   _lstsq_kernel and _lstsq_kernel_masked):
//     g = 2 X^T (X w - y),  rows >= n_t masked out of the residual
//   (n_t = n when the buffer has no padding).  X (n, d), w (d,), y (n,),
//   float32.
//
// Bound on the H100: bytes.  The n_t valid rows of X are read once from
//   device memory (7.9 MB at 240 x 8192); the 4 n_t d operations are two
//   orders of magnitude under the float32 rate.
//
// Design: the two-phase body of lstsq_grad_body.cuh with keep = row < n_t:
//   a padded row past n_t is never read (the TPU kernel reads and masks
//   it), and the column pass re-reads the valid rows, mostly from L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstsq_grad_body.cuh"

namespace {

struct PrefixKeep {
  int n_t;
  __device__ __forceinline__ bool operator()(int row) const {
    return row < n_t;
  }
  __device__ __forceinline__ float scale2() const { return 2.0f; }
};

}  // namespace

extern "C" int lstsq_grad_launch(const float* x, const float* w,
                                 const float* y, int n_t, float* r_scratch,
                                 float* g, int n, int d, void* stream) {
  if (n_t < 0 || n_t > n) return (int)cudaErrorInvalidValue;
  return launch_two_phase(x, w, y, r_scratch, g, n, d, PrefixKeep{n_t},
                          (cudaStream_t)stream);
}
