// Full least-squares task gradients of a batch of events on Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/lstsq_grad.py :: lstsq_grad (Pallas bodies
//   _lstsq_kernel and _lstsq_kernel_masked).  For each event e of a batch:
//     G[e] = 2 X_t^T (X_t w_e - y_t),  t = tasks[e],  rows >= n_t masked
//   out of the residual, with X_t = xs[t] (n, d), y_t = ys[t] (n,) and w_e
//   row e of a (B, d) tensor, all float32; n_t = row_counts[t] read on the
//   device (or a value: n for a uniform problem, the caller's count for a
//   one-task call).  The reference computes one event a call; the engines
//   ask for one (delta, dense), a batch step's B (batch) or every task
//   (FISTA's full gradient), and all of them are this one launch.
//
// Bound on the H100: bytes.  The n_t valid rows of each event's X are
//   needed once (8.39 MB at 256 x 8192: 2.50 us); the 4 n_t d operations
//   are far under the float32 rate.
//
// Design: one cluster of kCluster CTAs for each (event, row group), each
//   CTA owning a fixed slice of d (8 CTAs x 256 threads x one float4
//   cover d 8192).  A row group is kGroupRows rows; an event has
//   G = ceil(n / kGroupRows) groups, set by the buffer's capacity n, so
//   one event spreads over G clusters (16 at n 256: 128 CTAs).  A group
//   that starts at or past n_t reads no X.  In a group each thread loads
//   its columns of the group's rows into registers (16-byte loads, a warp
//   on 512 contiguous bytes of a row): at d <= 8192 the whole group is
//   one chunk, every load issued before the group's one reduction, and
//   two CTAs resident a SM overlap one group's reduction with another's
//   loads.  The partial dot products are reduced in the CTA (a warp xor
//   tree, then the warps in order) and across the cluster through
//   distributed shared memory in rank order, so every CTA holds the same
//   r_i = x_i . w - y_i; each thread then adds x_ij r_i over the group's
//   rows, in ascending order, from the registers it loaded: X's valid rows
//   are read from device memory once.
//   The sum across groups: each group writes its d-slice partial to a
//   (B, G, d) float32 scratch; the CTA that arrives last for its (event,
//   rank) (a counter a pair: after a CTA barrier, one thread's
//   __threadfence and atomicAdd on the counter only, the pattern of a grid
//   barrier) sums the partials of the groups below n_t in ascending order,
//   multiplies by 2, writes G[e] and puts the counter back to 0.  The
//   counters live in a buffer the wrapper zeroes once per device; every
//   launch leaves them at 0.  This assumes that two launches sharing a
//   buffer never run at once: the wrapper launches on PyTorch's current
//   stream, and the port issues every gradient on one stream.
//   Determinism: no sum uses an atomic, and every sum's order is fixed by
//   d (the column split), n, n_t and the constants (kCluster, kGroupRows,
//   kThreads) alone, never by B, the event's place in the batch,
//   which CTA arrives last or what is resident: row e of a batched launch
//   has the bits of a B = 1 launch of event e, on every launch.
//   Arithmetic: float32 __fmaf_rn / __fadd_rn, no TF32.
//   A task id outside [0, T) picks the task the reference's dynamic index
//   picks (ref.task_index): a negative id counts from the end, then the id
//   is clamped into [0, T).  n_t is clamped into [0, n].
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;     // CTAs a cluster, each a slice of d
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupRows = 16;  // rows a group (kernels/lstsq_grad.py's
                                // GROUP_ROWS); fixes the order of the sum
constexpr int kHeld = 16;       // rows x float4 groups a thread holds
constexpr int kSumBatch = 16;   // partials a thread loads at once to sum
constexpr int kMaxGroups = 8;   // float4 groups a thread owns (d <= 65536)

struct Batch {
  const float* xs;         // (T, n, d)
  const float* ys;         // (T, n)
  const int* tasks;        // (B,), or null: every event on `task`
  int task;
  const int* row_counts;   // (T,), or null: n_t = `n_t` for every task
  int n_t;
  const float* w;          // (B, d)
  float* g;                // (B, d)
  float* partial;          // (B, G, d) scratch
  int* counters;           // (B * kCluster,), zero between launches
  int num_t, n, d, groups;
  bool vec4;               // d % 4 == 0 and xs, w, g, partial 16-byte aligned
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Loads a thread's V float4 groups of columns `col` of `row` (zeros past d).
template <int V>
__device__ __forceinline__ void load_cols(const float* row, const int* col,
                                          int d, bool vec4, float (*out)[4]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (vec4) {
      if (col[i] < d) {
        const float4 a = *reinterpret_cast<const float4*>(row + col[i]);
        out[i][0] = a.x; out[i][1] = a.y; out[i][2] = a.z; out[i][3] = a.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) out[i][c] = 0.0f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        out[i][c] = col[i] + c < d ? row[col[i] + c] : 0.0f;
      }
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// V float4 groups a thread; chunks of R rows (kHeld / V, one at V = 8),
// kGroupRows / R of them a group.  The chunk does not change a sum's order.
template <int V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
lstsq_grad_kernel(const Batch bt) {
  constexpr int R = V < 8 ? kHeld / V : 1;      // rows a chunk
  __shared__ float red[kWarps][R];
  __shared__ float part[2][R];
  __shared__ float res[R];
  __shared__ int last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / kCluster;
  const int e = cid / bt.groups, grp = cid % bt.groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = bt.n, d = bt.d;

  int t = bt.tasks != nullptr ? bt.tasks[e] : bt.task;
  if (t < 0) t += bt.num_t;
  t = min(max(t, 0), bt.num_t - 1);
  const int n_t = min(max(bt.row_counts != nullptr ? bt.row_counts[t]
                                                   : bt.n_t, 0), n);

  // The thread's columns: group (i * kCluster + rank) * kThreads + tid
  // holds columns 4 * group .. 4 * group + 3.
  int col[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    col[i] = 4 * ((i * kCluster + rank) * kThreads + tid);
  }
  float acc[V][4];
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }

  const int row0 = grp * kGroupRows;
  const int rows = min(kGroupRows, n_t - row0);   // the same in the cluster
  if (rows > 0) {
    const float* x = bt.xs + ((size_t)t * n + row0) * d;
    const float* y = bt.ys + (size_t)t * n + row0;
    float wv[V][4];
    load_cols<V>(bt.w + (size_t)e * d, col, d, bt.vec4, wv);
    for (int base = 0, chunk = 0; base < rows; base += R, ++chunk) {
      const int cnt = min(R, rows - base);
      const float yv = tid < cnt ? y[base + tid] : 0.0f;
      float xr[R][V][4];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k < cnt) {
          load_cols<V>(x + (size_t)(base + k) * d, col, d, bt.vec4, xr[k]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) xr[k][i][c] = 0.0f;
          }
        }
      }
      float pd[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        pd[k] = 0.0f;
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
        float pv[kCluster];
#pragma unroll
        for (int q = 0; q < kCluster; ++q) {
          pv[q] = *cluster.map_shared_rank(&part[buf][tid], q);
        }
        float v = pv[0];
#pragma unroll
        for (int q = 1; q < kCluster; ++q) v = __fadd_rn(v, pv[q]);
        res[tid] = __fsub_rn(v, yv);
      }
      // the last chunk's reads of the other CTAs' part[] are done: arrive
      // now, wait before leaving
      if (base + R >= rows) cluster_arrive();
      __syncthreads();
      // += x_k r_k over the chunk's rows, in ascending row order
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
    }
    // this group's partial of the event's d-slice
    float* p = bt.partial + ((size_t)e * bt.groups + grp) * d;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (bt.vec4) {
        if (col[i] < d) {
          *reinterpret_cast<float4*>(p + col[i]) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (col[i] + c < d) p[col[i] + c] = acc[i][c];
        }
      }
    }
  }

  // The last of the event's G CTAs of this rank to arrive sums the slice:
  // the CTA's partial stores, then (thread 0) a fence and the arrival; the
  // last arrival's fence orders the other CTAs' partials before its reads.
  __syncthreads();
  int* counter = bt.counters + (size_t)e * kCluster + rank;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == bt.groups - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) {
    if (rows > 0) cluster_wait();   // no CTA leaves while another still
    return;                         // reads its part[]
  }
  const int valid = (n_t + kGroupRows - 1) / kGroupRows;
  const float* p0 = bt.partial + (size_t)e * bt.groups * d;
  float* gout = bt.g + (size_t)e * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q0 = 0; q0 < valid; q0 += kSumBatch) {
      // kSumBatch groups' partials loaded at once, then added in order
      float v[kSumBatch][4];
#pragma unroll
      for (int j = 0; j < kSumBatch; ++j) {
        const float* pq = p0 + (size_t)(q0 + j) * d;
#pragma unroll
        for (int c = 0; c < 4; ++c) v[j][c] = 0.0f;
        if (q0 + j >= valid) continue;
        if (bt.vec4) {
          if (col[i] < d) {
            const float4 a =
                __ldcg(reinterpret_cast<const float4*>(pq + col[i]));
            v[j][0] = a.x; v[j][1] = a.y; v[j][2] = a.z; v[j][3] = a.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (col[i] + c < d) v[j][c] = __ldcg(pq + col[i] + c);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSumBatch; ++j) {
        if (q0 + j < valid) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[c] = q0 + j == 0 ? v[j][c] : __fadd_rn(s[c], v[j][c]);
          }
        }
      }
    }
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = __fmul_rn(2.0f, s[c]);
    if (bt.vec4) {
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
  if (tid == 0) *counter = 0;
  if (rows > 0) cluster_wait();
}

template <int V>
int launch_v(const Batch& bt, int b, cudaStream_t stream) {
  const long long blocks = (long long)b * bt.groups * kCluster;
  lstsq_grad_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(bt);
  return (int)cudaGetLastError();
}

int launch_batch(Batch bt, int b, cudaStream_t stream) {
  if (b < 1 || bt.n < 0 || bt.d < 0 || bt.num_t < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (bt.d == 0) return (int)cudaSuccess;
  const int groups = (bt.d + 3) / 4;
  const int per = (groups + kCluster * kThreads - 1) / (kCluster * kThreads);
  if (per > kMaxGroups) return (int)cudaErrorInvalidValue;
  bt.groups = bt.n > 0 ? (bt.n + kGroupRows - 1) / kGroupRows : 1;
  if ((long long)b * bt.groups * kCluster > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  bt.vec4 = (bt.d % 4 == 0) &&
            ((reinterpret_cast<uintptr_t>(bt.xs) |
              reinterpret_cast<uintptr_t>(bt.w) |
              reinterpret_cast<uintptr_t>(bt.g) |
              reinterpret_cast<uintptr_t>(bt.partial)) % 16 == 0);
  if (per <= 1) return launch_v<1>(bt, b, stream);
  if (per <= 2) return launch_v<2>(bt, b, stream);
  if (per <= 4) return launch_v<4>(bt, b, stream);
  return launch_v<8>(bt, b, stream);
}

}  // namespace

// B events on xs (T, n, d) / ys (T, n).  `tasks` (B,) int32 on the device,
// or null for B = 1 on task `task`; `row_counts` (T,) int32 on the device,
// or null for n_t = `n_t`.  `partial` is (B, G, d) scratch, `counters`
// (B * 8,) int32 that are zero before the launch and after it.
extern "C" int lstsq_grad_launch(const float* xs, const float* ys,
                                 const int* tasks, int task,
                                 const int* row_counts, int n_t,
                                 const float* w, float* g, float* partial,
                                 int* counters, int num_t, int n, int d,
                                 int b, void* stream) {
  if (tasks == nullptr && b != 1) return (int)cudaErrorInvalidValue;
  Batch bt{xs, ys, tasks, task, row_counts, n_t, w, g, partial, counters,
           num_t, n, d, 0, false};
  return launch_batch(bt, b, (cudaStream_t)stream);
}
