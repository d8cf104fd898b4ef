// Seeded-minibatch least-squares gradients of a batch of events, and the
// selection bits alone, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lstsq_grad_sampled.py :: lstsq_grad_sampled
//   (Pallas bodies _sampled_kernel and _keep_bits) and :: sample_mask
//   (body _mask_kernel).  For each event e of a batch:
//     G[e] = (n_t/bsz) * 2 X_S^T (X_S w_e - y_S),  bsz = min(batch_size, n_t)
//   with X = xs[tasks[e]] (n, d), y = ys[tasks[e]] (n,), w_e = row e of the
//   events' prox columns (B, d), and row i in S iff keep_bit(block_e, i)
//   (counter_hash.cuh).  The blocks (seed, cut_h, cut_i, n_t) are planned
//   on the host, as the reference's _scalars computes them outside the
//   kernel, and read from a (B, 4) uint32 tensor (a single event passes its
//   block by value).  The reference scans one event at a time inside a
//   jitted step; here one launch computes the batch's B gradients, and a
//   single event is the same kernel with B = 1.
//
// Bound on the H100: bytes.  The function needs each event's bsz kept rows
//   of X (1 MB at 32 x 8192), its w and its G: about 35 MB at B = 32; the
//   4 bsz d operations an event are far under the float32 rate.  The TPU
//   kernel reads all n rows and masks them in VMEM.
//
// Design: a cluster of kCluster CTAs an event, each owning a slice of d.
//   Every CTA hashes the rows < n_t and compacts the kept ones in ascending
//   row order (ballot and popc) into a pending list; the list is taken in
//   chunks of R rows (16, or 8 when the batch has more events than the
//   card holds clusters of the wider chunk at once: 30 on an H100, against
//   45).  Per chunk each thread loads its columns of the R rows into
//   registers (16-byte loads, a warp on 512 contiguous bytes of a row) and
//   forms its partial dot products with w; the CTA reduces them
//   (a warp xor tree, then the warps in order) and the cluster adds the
//   CTAs' partials through distributed shared memory in rank order, so
//   every CTA holds the same r_k = x_k . w - y_k.  Each thread then
//   accumulates its columns of g from the rows still in its registers: X's
//   kept rows are read from device memory once, dropped rows never.
//   No atomics: each sum runs in an order fixed by d (the column split) and
//   the ascending kept rows alone, never by B, the event's place in the
//   batch or the other events of the launch, so row e of a batched launch
//   has the bits of a B = 1 launch of event e.
//   scale2 = 2 * (f32(n_t) / f32(max(bsz, 1))) is one float32 division of
//   integers below 2^24, the bits of the reference's 2*(n/bsz).
//   A task id outside [0, T) picks the task the reference's dynamic index
//   picks: a negative id counts from the end, then the id is clamped into
//   [0, T) (ref.task_index, the same rule on the CPU).
//   sample_mask writes the same keep bits, one thread a row; its engine
//   form sample_rows writes the kept rows of x and zeros for the others in
//   one launch, in place of the bits and a torch.where over all of x.  Its
//   bound is bytes: the kept rows read and all n rows written.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;     // CTAs an event, each a slice of d
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeld = 16;       // rows x float4 groups a thread holds a chunk
                                // (half that when the batch's clusters
                                // would not all be resident at once)
constexpr int kMaxGroups = 8;   // float4 groups a thread owns (d <= 65536)

struct Events {
  const float* xs;       // (T, n, d)
  const float* ys;       // (T, n)
  const int* tasks;      // (B,), or null: every event on task 0
  const float* w;        // (B, d)
  const uint32_t* scal;  // (B, 4), or null: `one` for every event
  ScalarBlock one;
  float* g;              // (B, d)
  int num_t, n, d;
  uint32_t batch_size;
  bool vec4;             // d % 4 == 0 and xs, w, g 16-byte aligned
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// V float4 groups a thread, R rows a chunk.
template <int V, int R>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
sampled_grad_kernel(const Events ev) {
  __shared__ int pending[R + kThreads];
  __shared__ int warp_base[kWarps + 1];
  __shared__ float red[kWarps][R];
  __shared__ float part[2][R];
  __shared__ float res[R];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = ev.n, d = ev.d;

  ScalarBlock s = ev.one;
  if (ev.scal != nullptr) {
    const uint32_t* q = ev.scal + 4 * (size_t)e;
    s = ScalarBlock{q[0], q[1], q[2], q[3]};
  }
  int t = ev.tasks != nullptr ? ev.tasks[e] : 0;
  if (t < 0) t += ev.num_t;
  t = min(max(t, 0), ev.num_t - 1);
  const float* x = ev.xs + (size_t)t * n * d;
  const float* y = ev.ys + (size_t)t * n;
  const float* w = ev.w + (size_t)e * d;

  // The thread's columns: group (i * kCluster + rank) * kThreads + tid
  // holds columns 4 * group .. 4 * group + 3.
  int col[V];
  float wv[V][4], acc[V][4];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    col[i] = 4 * ((i * kCluster + rank) * kThreads + tid);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[i][c] = 0.0f;
      wv[i][c] = 0.0f;
    }
    if (ev.vec4 && col[i] < d) {
      const float4 a = *reinterpret_cast<const float4*>(w + col[i]);
      wv[i][0] = a.x; wv[i][1] = a.y; wv[i][2] = a.z; wv[i][3] = a.w;
    } else if (!ev.vec4) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col[i] + c < d) wv[i][c] = w[col[i] + c];
      }
    }
  }

  // Hash the rows < n_t a window at a time, append the kept ones to
  // `pending` in ascending order, and take full chunks of R rows (at the
  // end, what is left).  `count` is the same in every thread of the cluster.
  const int n_scan = (int)min(s.n_t, (uint32_t)n);
  int count = 0;
  int chunk = 0;
  for (int base = 0;; base += kThreads) {
    if (base < n_scan) {
      const int row = base + tid;
      const bool keep = row < n_scan && keep_bit(s, (uint32_t)row);
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_base[warp] = __popc(m);
      __syncthreads();
      if (tid == 0) {
        int sum = 0;
        for (int q = 0; q < kWarps; ++q) {
          const int c = warp_base[q];
          warp_base[q] = sum;
          sum += c;
        }
        warp_base[kWarps] = sum;
      }
      __syncthreads();
      if (keep) {
        pending[count + warp_base[warp] + __popc(m & ((1u << lane) - 1u))] =
            row;
      }
      count += warp_base[kWarps];
      __syncthreads();
    }
    const bool last = base + kThreads >= n_scan;
    while (count >= R || (last && count > 0)) {
      const int cnt = min(count, R);
      // this chunk's rows into registers, and their partial dot products
      float xr[R][V][4];
      float pd[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        pd[k] = 0.0f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) xr[k][i][c] = 0.0f;
        }
        if (k < cnt) {
          const float* xrow = x + (size_t)pending[k] * d;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if (ev.vec4) {
              if (col[i] < d) {
                const float4 a =
                    *reinterpret_cast<const float4*>(xrow + col[i]);
                xr[k][i][0] = a.x; xr[k][i][1] = a.y;
                xr[k][i][2] = a.z; xr[k][i][3] = a.w;
              }
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (col[i] + c < d) xr[k][i][c] = xrow[col[i] + c];
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (col[i] + c < d) {
              pd[k] = __fmaf_rn(xr[k][i][c], wv[i][c], pd[k]);
            }
          }
        }
        pd[k] = warp_sum(pd[k]);
      }
      // the CTA's partials (warps in order), then the cluster's (ranks in
      // order) through distributed shared memory
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < R; ++k) red[warp][k] = pd[k];
      }
      __syncthreads();
      const int buf = chunk & 1;
      if (tid < R) {
        float v = red[0][tid];
        for (int q = 1; q < kWarps; ++q) v = __fadd_rn(v, red[q][tid]);
        part[buf][tid] = v;
      }
      cluster.sync();
      if (tid < cnt) {
        float v = *cluster.map_shared_rank(&part[buf][tid], 0);
        for (int q = 1; q < kCluster; ++q) {
          v = __fadd_rn(v, *cluster.map_shared_rank(&part[buf][tid], q));
        }
        res[tid] = __fsub_rn(v, y[pending[tid]]);
      }
      __syncthreads();
      // g += x_k r_k over the chunk's rows, in ascending row order
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k < cnt) {
          const float r = res[k];
#pragma unroll
          for (int i = 0; i < V; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[i][c] = __fmaf_rn(xr[k][i][c], r, acc[i][c]);
            }
          }
        }
      }
      ++chunk;
      count -= cnt;
      const int moved = tid < count ? pending[cnt + tid] : 0;
      __syncthreads();
      if (tid < count) pending[tid] = moved;
      __syncthreads();
    }
    if (last) break;
  }
  cluster.sync();   // no CTA leaves while another still reads its part[]

  const uint32_t bsz = min(ev.batch_size, s.n_t);
  const float scale2 =
      __fmul_rn(2.0f, __fdiv_rn((float)s.n_t, (float)max(bsz, 1u)));
  float* gout = ev.g + (size_t)e * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = __fmul_rn(scale2, acc[i][c]);
    if (ev.vec4) {
      if (col[i] < d) {
        *reinterpret_cast<float4*>(gout + col[i]) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col[i] + c < d) gout[col[i] + c] = o[c];
      }
    }
  }
}

template <int V, int R>
int launch_vr(const Events& ev, int b, cudaStream_t stream) {
  sampled_grad_kernel<V, R><<<b * kCluster, kThreads, 0, stream>>>(ev);
  return (int)cudaGetLastError();
}

// Chunks of kHeld / V rows while every event's cluster can be resident at
// once (the card's count, asked once), else of half that: fewer registers,
// more clusters resident.  The chunk does not change a sum's order.
template <int V>
int launch_v(const Events& ev, int b, cudaStream_t stream) {
  constexpr int kWide = kHeld / V, kNarrow = kWide > 1 ? kWide / 2 : 1;
  static int resident = -1;
  if (resident < 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &resident, sampled_grad_kernel<V, kWide>, &cfg);
    if (err != cudaSuccess) return (int)err;
  }
  if (b <= resident) return launch_vr<V, kWide>(ev, b, stream);
  return launch_vr<V, kNarrow>(ev, b, stream);
}

// B events; `ev.scal`/`ev.tasks` may be null (see Events).
int launch_events(Events ev, int b, cudaStream_t stream) {
  if (b < 1 || ev.n < 0 || ev.d < 0 || ev.batch_size < 1 ||
      (long long)b * kCluster > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (ev.d == 0) return (int)cudaSuccess;
  const int groups = (ev.d + 3) / 4;
  const int per = (groups + kCluster * kThreads - 1) / (kCluster * kThreads);
  if (per > kMaxGroups) return (int)cudaErrorInvalidValue;
  ev.vec4 = (ev.d % 4 == 0) &&
            ((reinterpret_cast<uintptr_t>(ev.xs) |
              reinterpret_cast<uintptr_t>(ev.w) |
              reinterpret_cast<uintptr_t>(ev.g)) % 16 == 0);
  if (per <= 1) return launch_v<1>(ev, b, stream);
  if (per <= 2) return launch_v<2>(ev, b, stream);
  if (per <= 4) return launch_v<4>(ev, b, stream);
  return launch_v<8>(ev, b, stream);
}

__global__ void sample_mask_kernel(ScalarBlock s, uint8_t* __restrict__ out,
                                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = keep_bit(s, (uint32_t)i) ? 1 : 0;
}

// x_s = where(keep_bits, x, 0): a block a (row, 256-vector slice); a kept
// row is copied (16-byte vectors, or words), a dropped row is written 0
// without reading x.
__global__ void sample_rows_kernel(ScalarBlock s, const float* __restrict__ x,
                                   float* __restrict__ out, int d, int slices,
                                   bool vec4) {
  const int row = blockIdx.x / slices;
  const int i = (blockIdx.x % slices) * blockDim.x + threadIdx.x;
  const bool keep = keep_bit(s, (uint32_t)row);
  if (vec4) {
    if (i >= d / 4) return;
    const size_t at = (size_t)row * (d / 4) + i;
    reinterpret_cast<float4*>(out)[at] =
        keep ? reinterpret_cast<const float4*>(x)[at]
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    if (i >= d) return;
    const size_t at = (size_t)row * d + i;
    out[at] = keep ? x[at] : 0.0f;
  }
}

}  // namespace

// B events on the tasks `tasks` of xs (T, n, d) / ys (T, n).
extern "C" int lstsq_grad_sampled_batch_launch(
    const float* xs, const float* ys, const int* tasks, const float* w,
    const unsigned* scalars, int batch_size, float* g, int num_t, int n,
    int d, int b, void* stream) {
  Events ev{xs, ys, tasks, w, scalars, ScalarBlock{0, 0, 0, 0}, g,
            num_t, n, d, (uint32_t)max(batch_size, 0), false};
  if (batch_size < 1 || num_t < 1) return (int)cudaErrorInvalidValue;
  return launch_events(ev, b, (cudaStream_t)stream);
}

// One event (the delta engine's call): the same kernel with B = 1, x (n, d)
// as a one-task xs, the scalar block by value.
extern "C" int lstsq_grad_sampled_launch(const float* x, const float* w,
                                         const float* y, unsigned seed,
                                         unsigned cut_h, unsigned cut_i,
                                         unsigned n_t, int batch_size,
                                         float* g, int n, int d,
                                         void* stream) {
  Events ev{x, y, nullptr, w, nullptr, ScalarBlock{seed, cut_h, cut_i, n_t},
            g, 1, n, d, (uint32_t)max(batch_size, 0), false};
  if (batch_size < 1) return (int)cudaErrorInvalidValue;
  return launch_events(ev, 1, (cudaStream_t)stream);
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

// The rows of x (n, d) kept by the scalar block's keep bits, the others 0,
// into out (n, d): sample_mask's bits formed where the rows are written.
extern "C" int sample_rows_launch(unsigned seed, unsigned cut_h,
                                  unsigned cut_i, unsigned n_t,
                                  const float* x, float* out, int n, int d,
                                  void* stream) {
  const int threads = 256;
  if (n < 0 || d < 0) return (int)cudaErrorInvalidValue;
  const bool vec4 = d % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  const int width = vec4 ? d / 4 : d;
  const int slices = (width + threads - 1) / threads;
  const long long blocks = (long long)n * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    sample_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        ScalarBlock{seed, cut_h, cut_i, n_t}, x, out, d, slices, vec4);
  }
  return (int)cudaGetLastError();
}
