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
//   d = 8192, B = 32, 1.5 us at 3.35 TB/s.  V is row-major (d, T), so a
//   column is one float every T: ~28 distinct columns of 128 touch most of
//   each row's sixteen 32-byte sectors, and the layout's own floor is
//   nearer the whole of V read and written.
//
// Design: one block a tile of R consecutive rows (R = 32 where shared
//   memory allows).  The block stages the tile's V rows (R, T) whole, its
//   p and g rows (R, B), the task ids and the eta_ks into shared memory
//   with coalesced asynchronous copies (cp.async), all in flight at once,
//   a warp along a row.  Rows are padded by one word, so a warp reading
//   one column over its 32 rows hits 32 banks.  From the B ids (a ballot,
//   a warp an event) it links each event to the next later event of the
//   same id: the events of one id form a chain, serialized in event order.
//   Then a warp per chain head, lanes over rows, walks the chain in
//   registers, writing each event's undo entry (coalesced across the warp)
//   and applying the reference's fma form (see amtl_event.cu), bitwise; no
//   two chains share a column, so there is no race.  The chain's last
//   value goes into the staged tile, which the block then writes back
//   whole, coalesced: on an H100 that took 6.5 us against 8.6 us for
//   storing the touched columns alone, where a warp's store spans 32
//   sectors (launch/sgd_kernel_phases.py times both).
//   A task id outside [0, T) is dropped: its chain never writes V (the
//   sharded engine's sentinel is T), and starts from what the reference's
//   clamped gather yields, the pre-batch column T-1 (kept aside, since a
//   chain of id T-1 may rewrite it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;
constexpr int kSmemLimit = 227 * 1024;

__device__ __forceinline__ float km(float cur, float p, float g, float eta,
                                    float eta_k) {
  return __fmaf_rn(eta_k, __fsub_rn(__fmaf_rn(-eta, g, p), cur), cur);
}

// A 4-byte copy from device to shared memory that does not stall the
// thread (cp.async); `cp.async.wait_all` ends them.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src)
               : "memory");
}

// Shared bytes of a tile of `rows` rows.
size_t tile_bytes(int rows, int num_t, int b) {
  return sizeof(uint32_t) * ((size_t)rows * (num_t + 1) + 2 * (size_t)rows *
                             (b + 1) + rows + b) +
         sizeof(int) * 3 * (size_t)b;
}

__global__ void __launch_bounds__(kThreads)
amtl_event_batch_kernel(uint32_t* __restrict__ v, const float* __restrict__ p,
                        const float* __restrict__ g,
                        const int* __restrict__ tasks,
                        const float* __restrict__ eta_ks, float eta,
                        uint32_t* __restrict__ undo, int d, int num_t, int b,
                        int rows) {
  extern __shared__ uint32_t smem[];
  const int vst = num_t + 1, pst = b + 1;
  uint32_t* vs = smem;                                   // (rows, T + 1)
  float* ps = reinterpret_cast<float*>(vs + (size_t)rows * vst);
  float* gs = ps + (size_t)rows * pst;                   // (rows, B + 1)
  uint32_t* last = reinterpret_cast<uint32_t*>(gs + (size_t)rows * pst);
  float* eks = reinterpret_cast<float*>(last + rows);    // (B,)
  int* ids = reinterpret_cast<int*>(eks + b);            // (B,)
  int* nxt = ids + b;                                    // next of the id
  int* head = nxt + b;                                   // first of the id

  const int row0 = blockIdx.x * rows;
  const int nr = min(rows, d - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;

  // Every copy of the tile in flight at once (cp.async), then one wait:
  // a warp a row at a time, lanes along it.
  for (int r = warp; r < nr; r += warps) {
    const uint32_t* vrow = v + (size_t)(row0 + r) * num_t;
    for (int c = lane; c < num_t; c += 32) copy4(vs + r * vst + c, vrow + c);
    const float* prow = p + (size_t)(row0 + r) * b;
    const float* grow = g + (size_t)(row0 + r) * b;
    for (int c = lane; c < b; c += 32) {
      copy4(ps + r * pst + c, prow + c);
      copy4(gs + r * pst + c, grow + c);
    }
  }
  for (int i = tid; i < b; i += blockDim.x) {
    copy4(ids + i, tasks + i);
    copy4(eks + i, eta_ks + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int r = tid; r < nr; r += blockDim.x) last[r] = vs[r * vst + num_t - 1];
  // The chains: a warp an event, the ids 32 at a time by ballot.  Event i
  // heads its chain if no earlier event has its id; nxt[i] is the next
  // later one (-1 at the end).
  for (int i = warp; i < b; i += warps) {
    const int t = ids[i];
    int next = -1;
    bool first = true;
    for (int j0 = 0; j0 < b; j0 += 32) {
      const int j = j0 + lane;
      const unsigned m = __ballot_sync(0xffffffffu, j < b && ids[j] == t);
      const int k = i - j0;       // event i's lane in this group of 32
      const unsigned before = k >= 32 ? m : k <= 0 ? 0u : m & ((1u << k) - 1u);
      const unsigned after =
          k < 0 ? m : k >= 31 ? 0u : m & ~((2u << k) - 1u);
      first = first && before == 0;
      if (next < 0 && after != 0) next = j0 + __ffs(after) - 1;
    }
    if (lane == 0) {
      nxt[i] = next;
      head[i] = first;
    }
  }
  __syncthreads();

  // A warp an event that heads its chain, lanes over rows: walk the chain.
  for (int i = warp; i < b; i += warps) {
    if (!head[i]) continue;
    const int t = ids[i];
    const bool kept = t >= 0 && t < num_t;
    for (int r = lane; r < nr; r += 32) {
      uint32_t cur = kept ? vs[r * vst + t] : last[r];
      for (int j = i; j >= 0; j = nxt[j]) {
        undo[(size_t)j * d + row0 + r] = cur;
        cur = __float_as_uint(km(__uint_as_float(cur), ps[r * pst + j],
                                 gs[r * pst + j], eta, eks[j]));
      }
      if (kept) vs[r * vst + t] = cur;
    }
  }
  __syncthreads();
  for (int r = warp; r < nr; r += warps) {
    uint32_t* vrow = v + (size_t)(row0 + r) * num_t;
    for (int c = lane; c < num_t; c += 32) vrow[c] = vs[r * vst + c];
  }
}

}  // namespace

// The rows a block takes for (T, B), or 0 when not one row fits in shared
// memory.
extern "C" int amtl_event_batch_rows(int num_t, int b) {
  for (int rows = kMaxRows; rows >= 1; rows >>= 1) {
    if (tile_bytes(rows, num_t, b) <= (size_t)kSmemLimit) return rows;
  }
  return 0;
}

extern "C" int amtl_event_batch_launch(float* v, const float* p,
                                       const float* g, const int* tasks,
                                       const float* eta_ks, float eta,
                                       float* undo, int d, int num_t, int b,
                                       void* stream) {
  if (d < 0 || num_t < 1 || b < 0) return (int)cudaErrorInvalidValue;
  if (d == 0 || b == 0) return (int)cudaSuccess;
  const int rows = amtl_event_batch_rows(num_t, b);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_bytes(rows, num_t, b);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        amtl_event_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (d + rows - 1) / rows;
  amtl_event_batch_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<uint32_t*>(v), p, g, tasks, eta_ks, eta,
      reinterpret_cast<uint32_t*>(undo), d, num_t, b, rows);
  return (int)cudaGetLastError();
}
