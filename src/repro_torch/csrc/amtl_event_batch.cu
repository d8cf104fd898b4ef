// Batched AMTL multi-event column update on Hopper (sm_90a), in place.
//
// Replaces: src/repro/kernels/amtl_event_batch.py :: amtl_event_batch
//   (Pallas body _make_kernel), the batch engine's column update for the
//   B events of one loop step.  For each event i in order, on the task
//   column t_i of V (d, T):
//     cur     = V[:, t_i]   (as left by the earlier events of the batch)
//     undo[i] = cur         (exact bits; the undo-log entry)
//     V[:, t_i] = cur + eta_k_i * (p_i - eta*g_i - cur)
//   The TPU kernel gathers and scatters the columns with one-hot matrix
//   products because a TPU cannot index lanes dynamically; that is a
//   layout workaround, and this kernel computes the same function with
//   plain indexed loads and stores.
//
// Bound on the H100: bytes.  The B task columns are read and written, p
//   and g (d, B) are read and undo (B, d) is written: about 5 MB at
//   d = 8192, B = 32, a microsecond or two at 3.35 TB/s.
//
// Design: one thread per row r of V.  The thread walks the B events in
//   order, so program order inside the thread serialises duplicate tasks
//   (a later duplicate reads the earlier event's write) with no forwarding
//   masks; no two threads touch the same element, so there is no race.
//   The KM update is the reference's fma form (see amtl_event.cu), bitwise.
//   Known weakness, left for later work: V is row-major (d, T), so each
//   column access is strided by T and neighbouring threads hit different
//   32-byte sectors.
//   A task id outside [0, T) is dropped: it never writes V (the sharded
//   engine's sentinel is T).  Its undo entry is what the reference's
//   clamped gather yields: the pre-batch column T-1, or the output of the
//   latest earlier event with the same id, recomputed from that event's
//   undo entry by the same fma sequence.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float km(float cur, float p, float g, float eta,
                                    float eta_k) {
  return __fmaf_rn(eta_k, __fsub_rn(__fmaf_rn(-eta, g, p), cur), cur);
}

__global__ void amtl_event_batch_kernel(uint32_t* __restrict__ v,
                                        const float* __restrict__ p,
                                        const float* __restrict__ g,
                                        const int* __restrict__ tasks,
                                        const float* __restrict__ eta_ks,
                                        float eta,
                                        uint32_t* __restrict__ undo, int d,
                                        int num_t, int b) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= d) return;
  uint32_t* vrow = v + (size_t)r * num_t;
  const float* prow = p + (size_t)r * b;
  const float* grow = g + (size_t)r * b;
  const uint32_t last = vrow[num_t - 1];
  for (int i = 0; i < b; ++i) {
    const int t = __ldg(tasks + i);
    const bool kept = t >= 0 && t < num_t;
    uint32_t cur;
    if (kept) {
      cur = vrow[t];
    } else {
      cur = last;
      for (int j = i - 1; j >= 0; --j) {
        if (__ldg(tasks + j) == t) {
          cur = __float_as_uint(km(__uint_as_float(undo[(size_t)j * d + r]),
                                   prow[j], grow[j], eta, __ldg(eta_ks + j)));
          break;
        }
      }
    }
    undo[(size_t)i * d + r] = cur;
    const float out = km(__uint_as_float(cur), prow[i], grow[i], eta,
                         __ldg(eta_ks + i));
    if (kept) vrow[t] = __float_as_uint(out);
  }
}

}  // namespace

extern "C" int amtl_event_batch_launch(float* v, const float* p,
                                       const float* g, const int* tasks,
                                       const float* eta_ks, float eta,
                                       float* undo, int d, int num_t, int b,
                                       void* stream) {
  const int threads = 64;
  const int blocks = (d + threads - 1) / threads;
  if (blocks > 0 && b > 0) {
    amtl_event_batch_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<uint32_t*>(v), p, g, tasks, eta_ks, eta,
        reinterpret_cast<uint32_t*>(undo), d, num_t, b);
  }
  return (int)cudaGetLastError();
}
