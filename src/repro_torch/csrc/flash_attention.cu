// Flash attention with GQA, causal and sliding-window masks, a key-count
// limit and a logit softcap, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (Pallas
//   body _flash_kernel), generalized to what the model's `mha`
//   (src/repro/models/attention.py) needs, so that prefill and decode both
//   run here:
//     q (B, Sq, H, hd), k and v (B, Skv, Hkv, hd), o (B, Sq, H, hd), in the
//     model's own layout (nothing transposed, kv heads never repeated):
//     query head h reads kv head h / (H / Hkv).
//     The query at row r sits at position i = q_offset + r.  Key j is kept
//     iff j < kv_len, and (not causal or j <= i), and (window == 0 or
//     j > i - window).
//     logits = q.k * scale; with softcap > 0, cap * tanh(logits / cap);
//     masked logits are -1e30; online softmax with float32 (m, l, acc);
//     o = acc / max(l, 1e-30) in the input type (float32 or bfloat16).
//
// Bound on the H100: operations.  The gemma2-2b prefill does 4 hd per kept
//   (query, key) pair, 205 GFLOP for a global layer at B 2, S 5000, against
//   123 MB of q, k, v and o; decode (Sq 1) is bound by reading the cache.
//
// Design (a simple, correct first version; speed is later work):
//   - one block of 256 threads for each (tile of 64 queries, head, batch);
//   - the block walks only the 64-key tiles that the causal and window
//     masks reach; skipping a tile in which every key is masked is exact,
//     since the reference multiplies such entries by exp(-1e30 - m) = 0
//     once a kept key has arrived;
//   - q, k and v tiles are staged in shared memory as float32 with a row
//     stride of hd + 1 (no bank conflicts on the column walk), the 64 x 64
//     logits in a fourth buffer; at hd 256 that is 210 KB of dynamic shared
//     memory, above the 48 KB default, so the launch opts in with
//     cudaFuncSetAttribute;
//   - S = Q K^T and acc += P V run on the CUDA cores in float32, each thread
//     owning a 4-row block and every 16th column; four threads share a row
//     for the running max and sum (shuffles), as the reference orders them:
//     m_new = max(m, rowmax), p = exp(s - m_new), corr = exp(m - m_new),
//     l = l corr + sum p, acc = acc corr + p v.
//   A row with no kept key at all (not reachable from the serving path)
//   gives 0, where the reference's chunk scan averages the masked values.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries a block
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + 64) of a (rows, heads, hd) slab at head `head` into a
// (64, ld) float32 tile; rows at or past `rows` become zero.  Warp w takes
// rows w, w + 8, ...; its lanes walk hd, so each row is one coalesced read.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, int ld, const T* base,
                                          int rows, int row0, int heads,
                                          int head, int hd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int row = row0 + r;
    float* dst = tile + r * ld;
    if (row < rows) {
      const T* src = base + ((int64_t)row * heads + head) * hd;
      for (int d = lane; d < hd; d += 32) dst[d] = to_f32(src[d]);
    } else {
      for (int d = lane; d < hd; d += 32) dst[d] = 0.0f;
    }
  }
}

// HDPAD: hd rounded up to 64, 128 or 256; each thread keeps HDPAD / 16
// accumulator columns of its four rows in registers.
template <typename T, int HDPAD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int h, int hkv, int hd, int causal,
                       int window, float softcap, int q_offset, int kv_len,
                       float scale) {
  constexpr int NJ = HDPAD / 16;
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                      // (64, ld)
  float* ks = qs + BQ * ld;              // (64, ld)
  float* vs = ks + BK * ld;              // (64, ld)
  float* ps = vs + BK * ld;              // (64, 65) logits, then p
  float* m_s = ps + BQ * (BK + 1);       // (64,) running max
  float* l_s = m_s + BQ;                 // (64,) running sum
  float* c_s = l_s + BQ;                 // (64,) this tile's correction

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int khead = head / (h / hkv);
  const T* qb = q + (int64_t)b * sq * h * hd;
  const T* kb = k + (int64_t)b * skv * hkv * hd;
  const T* vb = v + (int64_t)b * skv * hkv * hd;
  T* ob = o + (int64_t)b * sq * h * hd;

  load_tile(qs, ld, qb, sq, q0, h, head, hd);
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }

  // The key range that any query of this tile keeps.
  const int i_first = q_offset + q0;
  const int i_last = q_offset + min(q0 + BQ, sq) - 1;
  int hi = kv_len;
  if (causal) hi = min(hi, i_last + 1);
  int lo = 0;
  if (window > 0) lo = max(0, i_first - window + 1);

  // S / PV thread tile: rows ty*4 .. ty*4+3, columns tx + 16 j.
  const int ty = tid / 16, tx = tid % 16;
  // softmax: four threads a row, 16 columns each
  const int srow = tid / 4, spart = tid % 4;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();   // the previous tile's P V is done with ks, vs, ps
    load_tile(ks, ld, kb, skv, k0, hkv, khead, hd);
    load_tile(vs, ld, vb, skv, k0, hkv, khead, hd);
    __syncthreads();

    // S = Q K^T, scaled, capped and masked, into ps
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int pos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int key = k0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool keep = key < kv_len;
        if (causal) keep = keep && key <= pos;
        if (window > 0) keep = keep && key > pos - window;
        ps[r * (BK + 1) + c] = keep ? x : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax of row srow over this tile
    {
      float* prow = ps + srow * (BK + 1) + spart * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[srow];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (spart == 0) {
        const float corr = expf(m_old - m_new);
        c_s[srow] = corr;
        l_s[srow] = l_s[srow] * corr + sum;
        m_s[srow] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (BK + 1) + c];
      const float* vrow = vs + c * ld;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < hd ? vrow[col] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q0 + r;
    if (row >= sq) continue;
    // a row whose running max is still the mask value kept no key: 0
    const bool kept = m_s[r] != NEG_INF;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* dst = ob + ((int64_t)row * h + head) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) store(dst + col, kept ? acc[i][j] / den : 0.0f);
    }
  }
}

template <typename T, int HDPAD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int h, int hkv, int hd, int causal, int window,
           float softcap, int q_offset, int kv_len, float scale,
           cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * ((size_t)3 * BQ * (hd + 1) + BQ * (BK + 1) + 3 * BQ);
  auto kern = flash_attention_kernel<T, HDPAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, h, hkv, hd,
      causal, window, softcap, q_offset, kv_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int skv, int h, int hkv, int hd, int causal,
                int window, float softcap, int q_offset, int kv_len,
                float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, b, sq, skv, h, hkv, hd, causal, window,
                         softcap, q_offset, kv_len, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, b, sq, skv, h, hkv, hd, causal,
                          window, softcap, q_offset, kv_len, scale, stream);
  return launch<T, 256>(q, k, v, o, b, sq, skv, h, hkv, hd, causal, window,
                        softcap, q_offset, kv_len, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window 0 means none; softcap 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int b, int sq, int skv, int h, int hkv,
                                      int hd, int causal, int window,
                                      float softcap, int q_offset, int kv_len,
                                      float scale, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || h % hkv != 0 || hd <= 0 ||
      hd > 256 || kv_len < 0 || kv_len > skv || window < 0 || h > 65535 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, b, sq, skv, h, hkv, hd, causal,
                              window, softcap, q_offset, kv_len, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, b, sq, skv, h, hkv, hd,
                                      causal, window, softcap, q_offset,
                                      kv_len, scale, s);
  return (int)cudaErrorInvalidValue;
}
