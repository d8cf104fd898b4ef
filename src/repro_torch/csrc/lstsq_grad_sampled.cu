// Seeded-minibatch least-squares gradient and its selection bits on Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/lstsq_grad_sampled.py :: lstsq_grad_sampled
//   (Pallas bodies _sampled_kernel and _keep_bits) and :: sample_mask
//   (body _mask_kernel):
//     g = (n_t/bsz) * 2 X_S^T (X_S w - y_S),  bsz = min(batch_size, n_t)
//   where row i is in S iff keep_bit(scalar block, i) (counter_hash.cuh).
//   The block (seed, cut_h, cut_i, n_t) is planned on the host, as the
//   reference's _scalars computes it outside the kernel, and rides in the
//   kernel arguments.
//
// Bound on the H100: bytes, and at the engine's widths launch latency.
//   The function needs only the bsz kept rows of X (1 MB at 32 x 8192);
//   the TPU kernel reads all n rows and masks them in VMEM.
//
// Design: the two-phase body of lstsq_grad_body.cuh with keep = keep_bit:
//   a dropped row costs one hash and is never read.
//   scale2 = 2 * (f32(n_t) / f32(max(bsz, 1))) is derived from the block
//   as the TPU kernel derives it: one float32 division of integers below
//   2^24, so it has the bits of the reference's 2*(n/bsz) rounded to f32.
//   sample_mask writes the same keep bits, one thread a row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "lstsq_grad_body.cuh"

namespace {

struct SampledKeep {
  ScalarBlock s;
  uint32_t batch_size;
  __device__ __forceinline__ bool operator()(int row) const {
    return keep_bit(s, (uint32_t)row);
  }
  __device__ __forceinline__ float scale2() const {
    const uint32_t bsz = min(batch_size, s.n_t);
    return __fmul_rn(2.0f, __fdiv_rn((float)s.n_t, (float)max(bsz, 1u)));
  }
};

__global__ void sample_mask_kernel(ScalarBlock s, uint8_t* __restrict__ out,
                                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = keep_bit(s, (uint32_t)i) ? 1 : 0;
}

}  // namespace

extern "C" int lstsq_grad_sampled_launch(const float* x, const float* w,
                                         const float* y, unsigned seed,
                                         unsigned cut_h, unsigned cut_i,
                                         unsigned n_t, int batch_size,
                                         float* r_scratch, float* g, int n,
                                         int d, void* stream) {
  if (batch_size < 1) return (int)cudaErrorInvalidValue;
  const SampledKeep keep{ScalarBlock{seed, cut_h, cut_i, n_t},
                         (uint32_t)batch_size};
  return launch_two_phase(x, w, y, r_scratch, g, n, d, keep,
                          (cudaStream_t)stream);
}

extern "C" int sample_mask_launch(unsigned seed, unsigned cut_h,
                                  unsigned cut_i, unsigned n_t,
                                  unsigned char* out, int n, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    sample_mask_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        ScalarBlock{seed, cut_h, cut_i, n_t}, out, n);
  }
  return (int)cudaGetLastError();
}
