// Split-KV attention for calls with few query rows (decode), on Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (Pallas
//   body _flash_kernel), on the decode calls of the model's `mha`
//   (src/repro/models/attention.py): the `split` route of
//   repro_torch/kernels/flash_attention.py.  It computes the whole function
//   that csrc/flash_attention.cu computes (GQA, causal and window masks,
//   kv_len, q_offset, softcap; float32 (m, l, acc); o in q's type), for
//   float32 and bfloat16 with hd <= 256 a multiple of 8 and Sq * (H / Hkv)
//   <= 64 query rows a kv head.
//
// Bound on the H100: bytes.  A gemma2-2b decode call (Sq 1, 2 query heads a
//   kv head) reads the kv_len valid rows of its kv head's K and V once and
//   does 4 hd operations a key for each of its 2 rows: 33.5 MB and 17 MFLOP
//   on the 4096-slot ring, so the card's memory rate sets the time.
//
// Design:
//   - one block of 128 threads for each (split, kv head, batch, group of up
//     to 8 query rows); the rows of a kv head are r = i * G + g (query row
//     i, head g of the group), so the block reads its split of the cache once
//     for all the query heads that share it;
//   - split s holds the keys [s * chunk, min((s + 1) * chunk, kv_len)); the
//     host picks chunk and the split count so that the card holds at least
//     two blocks an SM (repro_torch/kernels/flash_attention.py :: split_plan);
//   - the block walks its split in sub-tiles of 4 U keys, warp w taking U
//     keys in a row; a lane loads 16 bytes of each key's K and V row (all U
//     keys' loads issued before their use, so each warp keeps U * 512 bytes
//     in flight), dots its slice of K with the rows' q (held in registers),
//     the warp sums the slices with shuffles, and lane (u * ROWS + r) % 32
//     scales, caps and masks pair (u, r) (a transposing butterfly, 31
//     shuffles for 32 pairs, measured slower on the H100); the logits go
//     through shared memory to the online softmax (one warp a row), and each
//     warp adds p v for its keys to its partial acc; the four partials are
//     summed in shared memory at the end;
//   - each block writes (m, l, acc) of its rows to float32 scratch; a split
//     with no kept key writes m = -1e30, l = 0, acc = 0, so its weight in
//     the merge is exp(-1e30 - M) = 0 as the reference's masked chunk gives;
//   - the combine kernel merges the splits: M = max m_s, L = sum l_s
//     exp(m_s - M), o = sum acc_s exp(m_s - M) / max(L, 1e-30) (both sums
//     across threads: four interleaved runs over the splits, each in order).
//   Within a split a masked key gets p = 0 (the reference's masked chunk
//   before any kept key would give p = 1, which a kept key later multiplies
//   by exp(-1e30 - m) = 0); a row with no kept key at all gives 0.
//   The CUDA cores do the arithmetic: two rows a key are far below the
//   tensor cores' 64-row tile, and the cache's bytes bound the call anyway.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 8;        // query rows a block
constexpr int DPL = 8;             // dims a lane holds (hd <= 256)
constexpr int MAX_SPLITS = 8192;   // the combine's weights in shared memory
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void unpack(const uint4& u, float* x,
                                       const float*) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* x,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ROWS: query rows of the block (1, 2, 4 or 8).  A lane holds the dims
// (v * 32 + lane) * VEC + e of each row, v < NV, e < VEC: one 16-byte vector
// (bfloat16) or two (float32) of a 256-wide row.
template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int sq, int skv, int h,
                    int hkv, int hd, int causal, int window, float softcap,
                    int q_offset, int kv_len, float scale, int num_splits,
                    int chunk, int row_groups) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = DPL / VEC;
  constexpr int U = (ROWS <= 2 ? 16 : ROWS == 4 ? 8 : 4) / NV;  // keys a warp
  constexpr int TK = WARPS * U;                              // keys a sub-tile
  __shared__ float s_tile[ROWS][TK];
  __shared__ float m_s[ROWS], l_s[ROWS], c_s[ROWS];
  __shared__ float red[WARPS][ROWS][DPL * 32];

  const int split = blockIdx.x, kh = blockIdx.y;
  const int b = blockIdx.z / row_groups, rg = blockIdx.z % row_groups;
  const int g = h / hkv, rows = sq * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = rg * MAX_ROWS;

  // positions of this block's rows, and the key range any of them keeps
  int pos_lo = INT32_MAX, pos_hi = INT32_MIN;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r0 + r < rows) {
      const int p = q_offset + (r0 + r) / g;
      pos_lo = min(pos_lo, p);
      pos_hi = max(pos_hi, p);
    }
  }
  int lo = split * chunk, hi = min(lo + chunk, kv_len);
  if (causal) hi = min(hi, pos_hi + 1);
  if (window > 0) lo = max(lo, pos_lo - window + 1);

  float qr[ROWS][DPL], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = r0 + r;
    const bool ok = row < rows;
    const int i = ok ? row / g : 0, head = kh * g + (ok ? row % g : 0);
    const T* src = q + (((int64_t)b * sq + i) * h + head) * hd;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
      const int d0 = (vv * 32 + lane) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[r][vv * VEC + e] = ok && d0 < hd ? to_f32(src[d0 + e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.0f;
  }
  if (threadIdx.x < ROWS) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  const int64_t kv_row = (int64_t)hkv * hd;
  const T* kb = k + ((int64_t)b * skv * hkv + kh) * hd;
  const T* vb = v + ((int64_t)b * skv * hkv + kh) * hd;
  for (int t0 = lo; t0 < hi; t0 += TK) {
    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = t0 + warp * U + u;
#pragma unroll
      for (int vv = 0; vv < NV; ++vv) {
        const int d0 = (vv * 32 + lane) * VEC;
        if (key < hi && d0 < hd) {
          kr[u][vv] = *reinterpret_cast<const uint4*>(kb + key * kv_row + d0);
          vr[u][vv] = *reinterpret_cast<const uint4*>(vb + key * kv_row + d0);
        } else {
          kr[u][vv] = make_uint4(0, 0, 0, 0);
          vr[u][vv] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    // logits of this warp's U keys: after the shuffles every lane holds each
    // (key, row) dot, and lane (u * ROWS + r) % 32 scales, caps and masks it
    float mine[(U * ROWS + 31) / 32];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[DPL];
#pragma unroll
      for (int vv = 0; vv < NV; ++vv)
        unpack(kr[u][vv], kx + vv * VEC, (const T*)nullptr);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) s = fmaf(qr[r][e], kx[e], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == (u * ROWS + r) % 32) mine[(u * ROWS + r) / 32] = s;
      }
    }
#pragma unroll
    for (int w = 0; w < (U * ROWS + 31) / 32; ++w) {
      const int pair = w * 32 + lane;
      if (pair >= U * ROWS) break;
      const int u = pair / ROWS, r = pair % ROWS;
      const int key = t0 + warp * U + u;
      float x = mine[w] * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      const int pos = q_offset + (r0 + r) / g;
      bool keep = key < hi && r0 + r < rows;
      if (causal) keep = keep && key <= pos;
      if (window > 0) keep = keep && key > pos - window;
      s_tile[r][warp * U + u] = keep ? x : NEG_INF;
    }
    __syncthreads();
    // online softmax of row r over the sub-tile, one warp a row
    for (int r = warp; r < ROWS; r += WARPS) {
      float x0 = lane < TK ? s_tile[r][lane] : NEG_INF;
      float x1 = lane + 32 < TK ? s_tile[r][lane + 32] : NEG_INF;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = x0 > NEG_INF ? expf(x0 - m_new) : 0.0f;
      const float p1 = x1 > NEG_INF ? expf(x1 - m_new) : 0.0f;
      if (lane < TK) s_tile[r][lane] = p0;
      if (lane + 32 < TK) s_tile[r][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p v over this warp's keys
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float corr = c_s[r];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[DPL];
#pragma unroll
      for (int vv = 0; vv < NV; ++vv)
        unpack(vr[u][vv], vx + vv * VEC, (const T*)nullptr);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = s_tile[r][warp * U + u];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(p, vx[e], acc[r][e]);
      }
    }
    __syncthreads();   // s_tile is rewritten by the next sub-tile
  }

  // sum the four warps' partial acc, write (m, l, acc) of each row
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) red[warp][r][e * 32 + lane] = acc[r][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < ROWS * 32 * DPL; idx += THREADS) {
    const int r = idx / (32 * DPL), j = idx % (32 * DPL);
    const int e = j / 32, ln = j % 32;
    const int d = ((e / VEC) * 32 + ln) * VEC + e % VEC;
    const int row = r0 + r;
    if (row >= rows || d >= hd) continue;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][r][j];
    const int64_t slot = (((int64_t)b * hkv + kh) * rows + row) * num_splits
        + split;
    part_acc[slot * hd + d] = sum;
    if (d == 0) {
      part_ml[2 * slot] = m_s[r];
      part_ml[2 * slot + 1] = l_s[r];
    }
  }
}

// One block for each (query row, query head, batch): merges the splits of
// its row.  The splits' weights exp(m_s - M) go to shared memory; then
// thread t sums acc_s w_s over the splits s = t / 64 (mod 4), in order,
// for the four dims of its 16-byte vector t % 64, its loads all in flight
// at once; the four partial sums meet in shared memory.
constexpr int C_THREADS = 256;
constexpr int C_WARPS = C_THREADS / 32;
constexpr int C_GROUPS = C_THREADS / 64;

template <typename T>
__global__ void __launch_bounds__(C_THREADS)
flash_decode_combine(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ o,
                     int sq, int h, int hkv, int hd, int num_splits) {
  extern __shared__ float w_s[];       // (num_splits,)
  __shared__ float red[C_WARPS];
  __shared__ float4 sums[C_GROUPS][64];
  const int i = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int g = h / hkv, kh = head / g, rows = sq * g;
  const int row = i * g + head % g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t slot0 = (((int64_t)b * hkv + kh) * rows + row) * num_splits;
  float mx = NEG_INF;
  for (int s = threadIdx.x; s < num_splits; s += C_THREADS)
    mx = fmaxf(mx, part_ml[2 * (slot0 + s)]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < C_WARPS; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();
  float den = 0.0f;
  for (int s = threadIdx.x; s < num_splits; s += C_THREADS) {
    const float wt = expf(part_ml[2 * (slot0 + s)] - mx);
    w_s[s] = wt;
    den += part_ml[2 * (slot0 + s) + 1] * wt;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, off);
  if (lane == 0) red[warp] = den;
  __syncthreads();
  den = 0.0f;
#pragma unroll
  for (int w = 0; w < C_WARPS; ++w) den += red[w];
  den = fmaxf(den, 1e-30f);

  const int dv = threadIdx.x % 64, grp = threadIdx.x / 64;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (dv * 4 < hd) {
#pragma unroll 8
    for (int s = grp; s < num_splits; s += C_GROUPS) {
      const float4 a = *reinterpret_cast<const float4*>(
          part_acc + (slot0 + s) * hd + dv * 4);
      const float wt = w_s[s];
      acc.x = fmaf(a.x, wt, acc.x);
      acc.y = fmaf(a.y, wt, acc.y);
      acc.z = fmaf(a.z, wt, acc.z);
      acc.w = fmaf(a.w, wt, acc.w);
    }
  }
  sums[grp][dv] = acc;
  __syncthreads();
  if (grp == 0 && dv * 4 < hd) {
#pragma unroll
    for (int q = 1; q < C_GROUPS; ++q) {
      acc.x += sums[q][dv].x;
      acc.y += sums[q][dv].y;
      acc.z += sums[q][dv].z;
      acc.w += sums[q][dv].w;
    }
    T* dst = o + (((int64_t)b * sq + i) * h + head) * hd + dv * 4;
    store(dst, acc.x / den);
    store(dst + 1, acc.y / den);
    store(dst + 2, acc.z / den);
    store(dst + 3, acc.w / den);
  }
}

template <typename T, int ROWS>
int launch_rows(const void* q, const void* k, const void* v, void* o,
                float* part_ml, float* part_acc, int b, int sq, int skv,
                int h, int hkv, int hd, int causal, int window, float softcap,
                int q_offset, int kv_len, float scale, int num_splits,
                int chunk, cudaStream_t stream) {
  const int rows = sq * (h / hkv);
  const int groups = (rows + MAX_ROWS - 1) / MAX_ROWS;
  dim3 grid(num_splits, hkv, b * groups);
  flash_decode_kernel<T, ROWS><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, part_ml, part_acc, sq, skv, h,
      hkv, hd, causal, window, softcap, q_offset, kv_len, scale, num_splits,
      chunk, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine<T><<<dim3(sq, h, b), C_THREADS,
                            num_splits * sizeof(float), stream>>>(
      part_ml, part_acc, (T*)o, sq, h, hkv, hd, num_splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* part_ml, float* part_acc, int b, int sq, int skv, int h,
           int hkv, int hd, int causal, int window, float softcap,
           int q_offset, int kv_len, float scale, int num_splits, int chunk,
           cudaStream_t stream) {
  const int rows = sq * (h / hkv);
  auto fn = rows <= 1 ? launch_rows<T, 1>
            : rows <= 2 ? launch_rows<T, 2>
            : rows <= 4 ? launch_rows<T, 4>
                        : launch_rows<T, 8>;
  return fn(q, k, v, o, part_ml, part_acc, b, sq, skv, h, hkv, hd, causal,
            window, softcap, q_offset, kv_len, scale, num_splits, chunk,
            stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  part_ml (B, Hkv, Sq * H / Hkv, splits, 2)
// and part_acc (B, Hkv, Sq * H / Hkv, splits, hd) are float32 scratch.
// num_splits * chunk must cover kv_len.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, void* o, void* part_ml,
                                   void* part_acc, int dtype, int b, int sq,
                                   int skv, int h, int hkv, int hd,
                                   int causal, int window, float softcap,
                                   int q_offset, int kv_len, float scale,
                                   int num_splits, int chunk, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || h % hkv != 0 ||
      sq * (h / hkv) > 64 || hd <= 0 || hd > 256 || hd % 8 != 0 ||
      kv_len < 0 || kv_len > skv || window < 0 || num_splits <= 0 ||
      chunk <= 0 || (int64_t)num_splits * chunk < kv_len || h > 65535 ||
      b * ((sq * (h / hkv) + MAX_ROWS - 1) / MAX_ROWS) > 65535 ||
      num_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  if (dtype == 0)
    return launch<float>(q, k, v, o, ml, acc, b, sq, skv, h, hkv, hd, causal,
                         window, softcap, q_offset, kv_len, scale,
                         num_splits, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, ml, acc, b, sq, skv, h, hkv, hd,
                                 causal, window, softcap, q_offset, kv_len,
                                 scale, num_splits, chunk, s);
  return (int)cudaErrorInvalidValue;
}
