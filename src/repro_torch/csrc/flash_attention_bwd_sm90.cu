// The gradients dQ, dK and dV of the port's attention function on Hopper's
// tensor cores (wgmma, TMA, mbarriers), bf16: the `sm90` route of
// kernels/flash_attention_bwd.py.
//
// Replaces no TPU kernel: the reference trains through its jnp
// online-softmax `mha` (src/repro/models/attention.py:52), which
// jax.value_and_grad differentiates, and has no Pallas backward.  This is
// the port's own gradient of the flash-attention kernel's function
// (src/repro/kernels/flash_attention.py:96), for the bf16 calls at every hd
// that is a multiple of 8 up to 256, the calls the forward's sm90 route
// takes; csrc/flash_attention_bwd.cu (CUDA cores) takes float32 and bf16 at
// an hd that is not a multiple of 8.
//
// It computes what csrc/flash_attention_bwd.cu computes (see its header):
// q (B, Sq, H, hd); k, v (B, Skv, Hkv, hd); o, dO (B, Sq, H, hd); query
// head h reading kv head h / (H / Hkv); key j kept for query row r
// (position i = q_offset + r) iff j < kv_len, (not causal or j <= i) and
// (no window or j > i - window); with x = scale q.k, s = cap tanh(x / cap):
//
//     P = softmax_kept(s), dV = P^T dO, dP = dO V^T, D = rowsum(dO * O),
//     dS = P (dP - D) (1 - (s / cap)^2), dQ = scale dS K, dK = scale dS^T Q,
//
// dK and dV of a kv head summed over its H / Hkv query heads, P = 0 for a
// row with no kept key, each gradient rounded once to bf16.  P and dS are
// rounded to bf16 where they feed a product, as FlashAttention-2 and -3 do
// (ref.mha_bwd_ref(p_dtype=torch.bfloat16) is that plain version).
//
// Bound on the H100: operations.  The function needs five products of
// 2 hd operations a kept (query, key) pair: at gemma2-2b's training shape
// (B 2, S 2048, H 8, Hkv 4, hd 256, causal) 85.9 GFLOP, 86.9 us at 989
// TFLOP/s bf16, against 67 MB of inputs and gradients (20 us at 3.35 TB/s).
// So every product runs on the tensor cores, bf16 operands with float32
// accumulators.
//
// Design: three kernels on one stream, each a producer warpgroup whose
// first thread issues every TMA load and two consumer warpgroups (setmaxnreg
// 24 / 240 registers a thread), one block an SM.  No atomics: each gradient
// element is summed in a fixed order by one block, so two launches give the
// same bits.
//
//   1. fa_bwd_sm90_lse, 128 query rows a block (64 a consumer): S = Q K^T
//      (wgmma m64n64k16, K tiles of 64 keys by TMA in a ring of 2 stages)
//      with the forward's online max and sum, in log2 units, gives each
//      row's lse2 = m + log2(l); a row with no kept key (and a row past Sq)
//      gets +inf, so that P = exp2(x2 - lse2) = 0 exactly.  D = rowsum(dO *
//      O) from 16-byte loads, two threads a row.  One product a pair.
//   2. fa_bwd_sm90_dq, 128 query rows a block, Q and dO resident, K and V
//      tiles of 32 keys in a ring of 2 stages: S = Q K^T and dP = dO V^T
//      (m64n32k16), P = exp2(x2 - lse2), dS in registers, rounded to bf16
//      as the A operand of dQ += dS K (m64n{hd}k16, K's tile read with the
//      transpose bit).  Three products a pair.
//   3. fa_bwd_sm90_dkdv, 64 keys of one kv head a block, K and V resident;
//      for each of the H / Hkv query heads in turn, the 64-row query tiles
//      that reach the keys, with Q, dO and the rows' lse2 and D (bulk
//      copies) in a ring of 2 stages.  The consumers split the work:
//      warpgroup 0 computes S^T = K Q^T, P^T, and dV += P^T dO; warpgroup 1
//      dP^T = V dO^T and dK += dS^T Q, dS^T = (P^T f)(dP^T - D) with P^T f
//      (f = 1 - (s / cap)^2) handed over from warpgroup 0 in float32
//      through 16 KB of shared memory, in the accumulator's own layout
//      (thread t of one reads what thread t of the other wrote; two named
//      barriers).  So each accumulator (64 x hd float32: 128 registers a
//      thread at hd 256) lives in one warpgroup, and S^T and dP^T are each
//      computed once.  Four products a pair.
//
// That is eight products a kept pair against the function's five (the
// score product three times: for the log-sum-exp, in the dQ pass and in the
// dK/dV pass; dO V^T twice), the price of keeping dQ and dK, dV in passes
// of their own without atomics: the design's own floor is 8/5 of the bound,
// 139 us at the training shape.  The scores are recomputed with the
// forward's instructions (tanh.approx, ex2.approx on logits times log2(e)),
// so the dQ pass's S is the lse pass's to the bit; the dK/dV pass computes
// K Q^T, another order of the same sums, so there P may exceed 1 by a
// rounding.  Each pass walks only the tiles a mask reaches, evaluates the
// mask per element only on tiles at a mask's edge, and issues its heaviest
// tiles first under the causal mask (the last query tiles for lse and dQ,
// the first key tiles for dK/dV).
//
// Every kernel computes at HP, hd rounded up to 64, 128, 192 or 256
// (`launch`'s switch; kernels/flash_attention.py :: sm90_width, the
// forward's widths), as csrc/flash_attention_sm90.cu does: the tensor maps
// are built at the real hd, so the row strides are the tensors' own and the
// 64-column boxes past hd arrive as zeros (their bytes still count toward
// the barriers' transactions; a box wider than the row, hd 8 to 56, too).
// Zero columns of Q, K, V and dO add nothing to S, dP or D, and give zero
// columns of dQ, dK and dV, which the epilogues never store: they write the
// hd / 8 real 8-column chunks of a row at the tensors' strides.  D sums
// over the real hd only.  The scale is the caller's, 1 / sqrt(hd), never
// 1 / sqrt(HP).  The padded work is HP / hd of the function's (128 / 80 at
// hubert-xlarge's hd 80, 128 / 112 at zamba2-7b's hd 112).
//
// Registers and shared memory a block at hd 256 (ptxas: 168 registers a
// thread at launch in each kernel, no spills; setmaxnreg then gives each
// consumer thread 240): lse holds 32 + 4 accumulator registers a consumer
// thread and 132136 bytes of dynamic shared memory; dq 128 (dQ) + 2 x 16
// (S, dP), 197688 bytes; dkdv 128 (dV or dK) + 32 (S^T or dP^T) + 16 (bf16
// fragments), 215080 bytes of the 232448 a block may have (at HP 192: 99368,
// 148536 and 165928 bytes, 96-register accumulators).  At the training shape
// each kernel has 256 blocks on 132 SMs: two waves, the second one short of
// work under the causal mask.
#include <math.h>

#include "sm90_wgmma.cuh"

namespace {

constexpr int BM = 64;               // rows of a consumer warpgroup's tile
constexpr int ROWS = 2 * BM;         // query rows of an lse or dq block
constexpr int THREADS = 384;         // a producer and two consumers
constexpr int STAGES = 2;
constexpr int LSE_BK = 64;           // keys of an lse tile
constexpr int DQ_BK = 32;            // keys of a dq tile
constexpr int KV_BK = 64;            // keys of a dkdv block
constexpr int KV_BQ = 64;            // query rows of a dkdv tile
constexpr int BOX64 = 64 * 128;      // bytes of a 64-column box of 64 rows
constexpr int BOX32 = 32 * 128;      // ... of 32 rows
constexpr int BAR_FULL = 1;          // named barriers of the dkdv hand-over
constexpr int BAR_EMPTY = 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;     // (B, H, sq_pad): each row's log-sum-exp, log2 units
  float* dsum;    // (B, H, sq_pad): each row's D
  int b, sq, skv, h, hkv, hd, causal, window, q_offset, kv_len, sq_pad;
  float cap, scale;
};

// d (64 x 32, f32) (+)= A (64 x 16) B (16 x 32), A and B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"((uint64_t)src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// x2 = s log2(e) of a raw dot product, s = cap tanh(scale dot / cap)
// (scale dot without a cap), by the forward's instructions; *f = ds/dx.
__device__ __forceinline__ float logit2(float dot, float scale, float cap,
                                        float inv_cap, float* f) {
  float x = dot * scale;
  if (cap > 0.0f) {
    const float t = tanh_approx(x * inv_cap);
    *f = 1.0f - t * t;
    x = cap * t;
  } else {
    *f = 1.0f;
  }
  return x * LOG2E;
}

__device__ __forceinline__ bool kept(const Params& p, int key, int pos) {
  return key < p.kv_len && (!p.causal || key <= pos) &&
         (p.window == 0 || key > pos - p.window);
}

// The key tiles [*t_lo, *t_hi) of `bk` keys that query positions
// [first, last] reach.
__device__ __forceinline__ void key_tiles(const Params& p, int first,
                                          int last, int bk, int* t_lo,
                                          int* t_hi) {
  int hi = p.kv_len, lo = 0;
  if (p.causal) hi = min(hi, last + 1);
  if (p.window > 0) lo = max(0, first - p.window + 1);
  *t_lo = lo / bk;
  *t_hi = hi > lo ? (hi + bk - 1) / bk : *t_lo;
}

// Whether keys [k0, k0 + bk) are all kept for query positions [first,
// last] (no mask edge inside the tile).
__device__ __forceinline__ bool interior(const Params& p, int k0, int bk,
                                         int first, int last) {
  return k0 + bk <= p.kv_len && (!p.causal || k0 + bk - 1 <= first) &&
         (p.window == 0 || k0 > last - p.window);
}

// Writes the first hd columns of a 64 x HP float32 accumulator (rows row0
// and row0 + 8 of this thread, `rows` valid) times `mul` as bf16 rows of
// `out` + row * stride.  The 8-column chunks at or past hd hold the zero
// columns of the padded operand and would land in the next head's row; hd
// is a multiple of 8, so no chunk straddles it.
template <int HP>
__device__ __forceinline__ void store_rows(const float (&acc)[HP / 2],
                                           __nv_bfloat16* out, int row0,
                                           int rows, size_t stride, int hd,
                                           float mul, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= rows) continue;
    __nv_bfloat16* dst = out + (size_t)row * stride;
#pragma unroll
    for (int j = 0; j < HP / 8; ++j)
      if (j * 8 < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + 2 * (lane % 4)) =
            __floats2bfloat162_rn(acc[j * 4 + 2 * i] * mul,
                                  acc[j * 4 + 2 * i + 1] * mul);
  }
}

// ------------------------------------------------------------- 1. lse, D

template <int HP>
struct LseLayout {
  static constexpr int CH = HP / 64;                 // boxes a row
  static constexpr int Q_BYTES = 2 * CH * BOX64;
  static constexpr int K_BYTES = CH * BOX64;         // one K tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int BAR_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int ALLOC = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HP>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_sm90_lse(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk, Params p) {
  using L = LseLayout<HP>;
  constexpr int CH = L::CH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t k_full = q_full + 8;                 // + 8 s
  const uint32_t empty = k_full + 8 * STAGES;         // + 8 s

  const int head = blockIdx.x % p.h, b = blockIdx.x / p.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heaviest first
  const int khead = head / (p.h / p.hkv);
  int t_lo, t_hi;
  key_tiles(p, p.q_offset + q0, p.q_offset + min(q0 + ROWS, p.sq) - 1,
            LSE_BK, &t_lo, &t_hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < 2; ++c)
        for (int ch = 0; ch < CH; ++ch)
          tma_load_4d(q_s + (c * CH + ch) * BOX64, &tq, q_full, ch * 64,
                      head, q0 + c * BM, b);
      int it = 0;
      for (int t = t_lo; t < t_hi; ++t, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          mbar_wait_guarded(empty + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, L::K_BYTES);
        for (int ch = 0; ch < CH; ++ch)
          tma_load_4d(k_s + s * L::K_BYTES + ch * BOX64, &tk,
                      k_full + 8 * s, ch * 64, khead, t * LSE_BK, b);
      }
      for (int j = max(0, it - STAGES); j < it; ++j)
        mbar_wait_guarded(empty + 8 * (j % STAGES), (j / STAGES) & 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + c * BM + warp * 16 + lane / 4;   // and row0 + 8
  const int pos0 = p.q_offset + row0;
  const bool live = q0 + c * BM < p.sq;
  const int c_first = p.q_offset + q0 + c * BM, c_last = c_first + BM - 1;
  const int c_hi = p.causal ? min(p.kv_len, c_last + 1) : p.kv_len;
  const int c_lo = p.window > 0 ? max(0, c_first - p.window + 1) : 0;
  const float inv_cap = p.cap > 0.0f ? 1.0f / p.cap : 0.0f;
  const size_t stat0 = ((size_t)b * p.h + head) * p.sq_pad;

  // D = rowsum(dO * O) over the real hd columns: two threads a row, the
  // even and the odd 8-column chunks, then the pair
  {
    const int r = q0 + c * BM + tid / 2, half = tid % 2;
    float d = 0.0f;
    if (r < p.sq) {
      const size_t off = (((size_t)b * p.sq + r) * p.h + head) * p.hd;
      const uint4* a = reinterpret_cast<const uint4*>(p.dout + off);
      const uint4* o = reinterpret_cast<const uint4*>(p.o + off);
#pragma unroll 4
      for (int i = half; i < p.hd / 8; i += 2) {
        const uint4 x = a[i], y = o[i];
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fx = __bfloat1622float2(x2[e]);
          const float2 fy = __bfloat1622float2(y2[e]);
          d = fmaf(fx.x, fy.x, d);
          d = fmaf(fx.y, fy.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) p.dsum[stat0 + r] = d;
  }

  float m[2] = {NEG_INF, NEG_INF};   // running max, log2 units
  float l[2] = {0.0f, 0.0f};         // this thread's share of the row sums
  mbar_wait(q_full, 0);
  const uint64_t q_desc = sw128_desc(q_s + c * CH * BOX64, 16, 1024);
  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int s = it % STAGES;
    const int k0 = t * LSE_BK;
    mbar_wait(k_full + 8 * s, (it / STAGES) & 1);
    if (live && k0 < c_hi && k0 + LSE_BK > c_lo) {
      const uint64_t k_desc = sw128_desc(k_s + s * L::K_BYTES, 16, 1024);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        wgmma_ss(sc, desc_at(q_desc, (kk / 4) * BOX64 + (kk % 4) * 32),
                 desc_at(k_desc, (kk / 4) * BOX64 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);
      const bool edge = !interior(p, k0, LSE_BK, c_first, c_last);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float f;
            float x = logit2(sc[cc * 4 + i * 2 + j], p.scale, p.cap, inv_cap,
                             &f);
            if (edge && !kept(p, k0 + cc * 8 + 2 * (lane % 4) + j,
                              pos0 + 8 * i))
              x = NEG_INF;
            sc[cc * 4 + i * 2 + j] = x;
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          mx = fmaxf(mx, fmaxf(sc[cc * 4 + i * 2], sc[cc * 4 + i * 2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float corr = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
#pragma unroll
          for (int j = 0; j < 2; ++j) sum += ex2(sc[cc * 4 + i * 2 + j] - m_new);
        l[i] = l[i] * corr + sum;
      }
    }
    mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (lane % 4 == 0)
      p.lse[stat0 + row] = (m[i] == NEG_INF || row >= p.sq)
                               ? INFINITY
                               : m[i] + log2f(l[i]);
  }
}

// ------------------------------------------------------------------ 2. dQ

template <int HP>
struct DqLayout {
  static constexpr int CH = HP / 64;
  static constexpr int Q_BYTES = 2 * CH * BOX64;     // Q (or dO) of a block
  static constexpr int KV_BYTES = CH * BOX32;        // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int ALLOC = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

template <int HP>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_sm90_dq(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo, Params p) {
  using L = DqLayout<HP>;
  constexpr int CH = L::CH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::DO_OFF;
  const uint32_t k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;          // Q and dO
  const uint32_t k_full = q_full + 8;                 // + 8 s
  const uint32_t v_full = k_full + 8 * STAGES;        // + 8 s
  const uint32_t empty = v_full + 8 * STAGES;         // + 8 s

  const int head = blockIdx.x % p.h, b = blockIdx.x / p.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heaviest first
  const int khead = head / (p.h / p.hkv);
  int t_lo, t_hi;
  key_tiles(p, p.q_offset + q0, p.q_offset + min(q0 + ROWS, p.sq) - 1,
            DQ_BK, &t_lo, &t_hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
      for (int c = 0; c < 2; ++c)
        for (int ch = 0; ch < CH; ++ch) {
          tma_load_4d(q_s + (c * CH + ch) * BOX64, &tq, q_full, ch * 64,
                      head, q0 + c * BM, b);
          tma_load_4d(do_s + (c * CH + ch) * BOX64, &tdo, q_full, ch * 64,
                      head, q0 + c * BM, b);
        }
      int it = 0;
      for (int t = t_lo; t < t_hi; ++t, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          mbar_wait_guarded(empty + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, L::KV_BYTES);
        for (int ch = 0; ch < CH; ++ch)
          tma_load_4d(k_s + s * L::KV_BYTES + ch * BOX32, &tk,
                      k_full + 8 * s, ch * 64, khead, t * DQ_BK, b);
        mbar_expect_tx(v_full + 8 * s, L::KV_BYTES);
        for (int ch = 0; ch < CH; ++ch)
          tma_load_4d(v_s + s * L::KV_BYTES + ch * BOX32, &tv,
                      v_full + 8 * s, ch * 64, khead, t * DQ_BK, b);
      }
      for (int j = max(0, it - STAGES); j < it; ++j)
        mbar_wait_guarded(empty + 8 * (j % STAGES), (j / STAGES) & 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + c * BM + warp * 16 + lane / 4;   // and row0 + 8
  const int pos0 = p.q_offset + row0;
  const bool live = q0 + c * BM < p.sq;
  const int c_first = p.q_offset + q0 + c * BM, c_last = c_first + BM - 1;
  const int c_hi = p.causal ? min(p.kv_len, c_last + 1) : p.kv_len;
  const int c_lo = p.window > 0 ? max(0, c_first - p.window + 1) : 0;
  const float inv_cap = p.cap > 0.0f ? 1.0f / p.cap : 0.0f;
  const size_t stat0 = ((size_t)b * p.h + head) * p.sq_pad;
  const float lse[2] = {p.lse[stat0 + row0], p.lse[stat0 + row0 + 8]};
  const float dd[2] = {p.dsum[stat0 + row0], p.dsum[stat0 + row0 + 8]};

  // dQ: 8-column chunk j of the 64 x hd tile in acc[4 j .. 4 j + 3]
  float acc[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) acc[i] = 0.0f;

  mbar_wait(q_full, 0);
  const uint64_t q_desc = sw128_desc(q_s + c * CH * BOX64, 16, 1024);
  const uint64_t do_desc = sw128_desc(do_s + c * CH * BOX64, 16, 1024);
  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int k0 = t * DQ_BK;
    mbar_wait(k_full + 8 * s, parity);
    mbar_wait(v_full + 8 * s, parity);
    if (live && k0 < c_hi && k0 + DQ_BK > c_lo) {
      const uint32_t kt = k_s + s * L::KV_BYTES, vt = v_s + s * L::KV_BYTES;
      const uint64_t k_desc = sw128_desc(kt, 16, 1024);
      const uint64_t v_desc = sw128_desc(vt, 16, 1024);
      float sc[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.0f;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        wgmma_ss(sc, desc_at(q_desc, (kk / 4) * BOX64 + (kk % 4) * 32),
                 desc_at(k_desc, (kk / 4) * BOX32 + (kk % 4) * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        wgmma_ss(dp, desc_at(do_desc, (kk / 4) * BOX64 + (kk % 4) * 32),
                 desc_at(v_desc, (kk / 4) * BOX32 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);
      fence_acc(dp);
      const bool edge = !interior(p, k0, DQ_BK, c_first, c_last);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = cc * 4 + i * 2 + j;
            float f;
            const float x = logit2(sc[e], p.scale, p.cap, inv_cap, &f);
            float pr = ex2(x - lse[i]);
            if (edge && !kept(p, k0 + cc * 8 + 2 * (lane % 4) + j,
                              pos0 + 8 * i))
              pr = 0.0f;
            sc[e] = pr * (dp[e] - dd[i]) * f;
          }
      // dS as the A operand: k-step kk takes S columns 16 kk .. 16 kk + 15
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      const uint64_t kt_desc = sw128_desc(kt, BOX32, 1024);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs(acc, pa[kk], desc_at(kt_desc, kk * 2048));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
    }
    mbar_arrive(empty + 8 * s);
  }
  store_rows<HP>(acc,
                 p.dq + (size_t)b * p.sq * p.h * p.hd + (size_t)head * p.hd,
                 row0, p.sq, (size_t)p.h * p.hd, p.hd, p.scale, lane);
}

// -------------------------------------------------------------- 3. dK, dV

template <int HP>
struct KvLayout {
  static constexpr int CH = HP / 64;
  static constexpr int TILE = CH * BOX64;            // 64 rows of K, V, Q, dO
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = TILE;
  static constexpr int Q_OFF = 2 * TILE;             // stage s: Q, then dO
  static constexpr int STAT_OFF = Q_OFF + STAGES * 2 * TILE;  // lse2, then D
  static constexpr int X_OFF = STAT_OFF + STAGES * 2 * KV_BQ * 4;
  static constexpr int BAR_OFF = X_OFF + 32 * 128 * 4;
  static constexpr int ALLOC = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HP>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_sm90_dkdv(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, Params p) {
  using L = KvLayout<HP>;
  constexpr int CH = L::CH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kv_full = base + L::BAR_OFF;         // K and V
  const uint32_t full = kv_full + 8;                  // + 8 s
  const uint32_t empty = full + 8 * STAGES;           // + 8 s

  const int kh = blockIdx.x % p.hkv, b = blockIdx.x / p.hkv;
  const int k0 = blockIdx.y * KV_BK;                  // heaviest first
  const int g = p.h / p.hkv;
  // the query rows [r_lo, r_hi) that keep a key of the block
  int r_lo = 0, r_hi = 0;
  if (k0 < p.kv_len) {
    const int k_last = min(k0 + KV_BK, p.kv_len) - 1;
    r_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
    r_hi = p.window > 0 ? min(p.sq, k_last + p.window - p.q_offset) : p.sq;
  }
  const int t_lo = r_lo / KV_BQ;
  const int n_t = r_hi > r_lo ? (r_hi + KV_BQ - 1) / KV_BQ - t_lo : 0;
  const int items = g * n_t;                          // (head, query tile)

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && items > 0) {
      mbar_expect_tx(kv_full, 2 * L::TILE);
      for (int ch = 0; ch < CH; ++ch) {
        tma_load_4d(base + L::K_OFF + ch * BOX64, &tk, kv_full, ch * 64, kh,
                    k0, b);
        tma_load_4d(base + L::V_OFF + ch * BOX64, &tv, kv_full, ch * 64, kh,
                    k0, b);
      }
      for (int it = 0; it < items; ++it) {
        const int h = kh * g + it / n_t, r0 = (t_lo + it % n_t) * KV_BQ;
        const int s = it % STAGES;
        if (it >= STAGES)
          mbar_wait_guarded(empty + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t qst = base + L::Q_OFF + s * 2 * L::TILE;
        mbar_expect_tx(full + 8 * s, 2 * L::TILE + 2 * KV_BQ * 4);
        for (int ch = 0; ch < CH; ++ch) {
          tma_load_4d(qst + ch * BOX64, &tq, full + 8 * s, ch * 64, h, r0, b);
          tma_load_4d(qst + L::TILE + ch * BOX64, &tdo, full + 8 * s,
                      ch * 64, h, r0, b);
        }
        const size_t at = ((size_t)b * p.h + h) * p.sq_pad + r0;
        const uint32_t st = base + L::STAT_OFF + s * 2 * KV_BQ * 4;
        bulk_load(st, p.lse + at, KV_BQ * 4, full + 8 * s);
        bulk_load(st + KV_BQ * 4, p.dsum + at, KV_BQ * 4, full + 8 * s);
      }
      for (int j = max(0, items - STAGES); j < items; ++j)
        mbar_wait_guarded(empty + 8 * (j % STAGES), (j / STAGES) & 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // warpgroup 0: S^T, P^T, dV; warpgroup 1: dP^T, dS^T, dK
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int key0 = k0 + warp * 16 + lane / 4;          // and key0 + 8
  const float inv_cap = p.cap > 0.0f ? 1.0f / p.cap : 0.0f;
  float* const xbuf = reinterpret_cast<float*>(gbase + L::X_OFF);

  // dV (warpgroup 0) or dK (1): chunk j of the 64 x hd tile in acc[4 j ..]
  float acc[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) acc[i] = 0.0f;

  if (items > 0) {
    mbar_wait(kv_full, 0);
    // A operand of this warpgroup's score-like product: K or V
    const uint64_t a_desc =
        sw128_desc(base + (c == 0 ? L::K_OFF : L::V_OFF), 16, 1024);
    for (int it = 0; it < items; ++it) {
      const int r0 = (t_lo + it % n_t) * KV_BQ;
      const int s = it % STAGES;
      const uint32_t qst = base + L::Q_OFF + s * 2 * L::TILE;
      const uint32_t dost = qst + L::TILE;
      const float* st = reinterpret_cast<const float*>(
          gbase + L::STAT_OFF + s * 2 * KV_BQ * 4);
      mbar_wait(full + 8 * s, (it / STAGES) & 1);

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1): 64 keys x 64 rows
      const uint64_t b_desc = sw128_desc(c == 0 ? qst : dost, 16, 1024);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        wgmma_ss(sc, desc_at(a_desc, (kk / 4) * BOX64 + (kk % 4) * 32),
                 desc_at(b_desc, (kk / 4) * BOX64 + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);

      if (c == 0) {
        // P^T (kept for dV) and P^T f, handed to warpgroup 1
        const bool edge =
            r0 + KV_BQ > p.sq ||
            !interior(p, k0, KV_BK, p.q_offset + r0,
                      p.q_offset + r0 + KV_BQ - 1);
        if (it > 0) bar_sync(BAR_EMPTY, 256);
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = cc * 4 + i * 2 + j;
              const int col = cc * 8 + 2 * (lane % 4) + j;
              float f;
              const float x = logit2(sc[e], p.scale, p.cap, inv_cap, &f);
              float pr = ex2(x - st[col]);
              if (edge && (r0 + col >= p.sq ||
                           !kept(p, key0 + 8 * i, p.q_offset + r0 + col)))
                pr = 0.0f;
              xbuf[e * 128 + tid] = pr * f;
              sc[e] = pr;
            }
        bar_arrive(BAR_FULL, 256);
      } else {
        // dS^T = (P^T f) (dP^T - D)
        bar_sync(BAR_FULL, 256);
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = cc * 4 + i * 2 + j;
              const int col = cc * 8 + 2 * (lane % 4) + j;
              sc[e] = xbuf[e * 128 + tid] * (sc[e] - st[KV_BQ + col]);
            }
        bar_arrive(BAR_EMPTY, 256);
      }

      // dV += P^T dO (0) or dK += dS^T Q (1): the 64 x 64 tile as the A
      // operand, k-step kk its columns 16 kk .. 16 kk + 15; dO or Q with
      // the transpose bit
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      const uint64_t bt_desc = sw128_desc(c == 0 ? dost : qst, BOX64, 1024);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, pa[kk], desc_at(bt_desc, kk * 2048));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      mbar_arrive(empty + 8 * s);
    }
    if (c == 0) bar_sync(BAR_EMPTY, 256);   // the last hand-over's release
  }
  store_rows<HP>(acc,
                 (c == 0 ? p.dv : p.dk) + (size_t)b * p.skv * p.hkv * p.hd +
                     (size_t)kh * p.hd,
                 key0, p.skv, (size_t)p.hkv * p.hd, p.hd,
                 c == 0 ? 1.0f : p.scale, lane);
}

template <int HP>
int launch(const void* q, const void* k, const void* v, const Params& p,
           cudaStream_t stream) {
  // runtime calls first: they bind the device's context to this thread
  // (autograd runs the backward on a thread of its own), which the
  // driver's tensor-map encoder then finds
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(fa_bwd_sm90_lse<HP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  LseLayout<HP>::ALLOC)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_sm90_dq<HP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DqLayout<HP>::ALLOC)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_sm90_dkdv<HP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  KvLayout<HP>::ALLOC)) != cudaSuccess)
    return (int)err;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  // the maps at the real hd: the boxes past it read as zeros
  CUtensorMap tq, tdo, tk64, tv64, tk32, tv32;
  if (!make_map(&tq, enc, q, p.b, p.sq, p.h, p.hd, BM) ||
      !make_map(&tdo, enc, p.dout, p.b, p.sq, p.h, p.hd, BM) ||
      !make_map(&tk64, enc, k, p.b, p.skv, p.hkv, p.hd, 64) ||
      !make_map(&tv64, enc, v, p.b, p.skv, p.hkv, p.hd, 64) ||
      !make_map(&tk32, enc, k, p.b, p.skv, p.hkv, p.hd, DQ_BK) ||
      !make_map(&tv32, enc, v, p.b, p.skv, p.hkv, p.hd, DQ_BK))
    return (int)cudaErrorInvalidValue;
  const dim3 gq(p.b * p.h, p.sq_pad / ROWS);
  const dim3 gk(p.b * p.hkv, (p.skv + KV_BK - 1) / KV_BK);
  fa_bwd_sm90_lse<HP><<<gq, THREADS, LseLayout<HP>::ALLOC, stream>>>(tq, tk64,
                                                                     p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_sm90_dq<HP><<<gq, THREADS, DqLayout<HP>::ALLOC, stream>>>(
      tq, tk32, tv32, tdo, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_sm90_dkdv<HP><<<gk, THREADS, KvLayout<HP>::ALLOC, stream>>>(
      tq, tk64, tv64, tdo, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v, o, dout, dq, dk, dv (16-byte aligned), hd a multiple of
// 8 up to 256, computed at the next multiple of 64.  lse and dsum are (B, H, sq_pad) float32 scratch that the wrapper
// allocates, sq_pad = Sq rounded up to a multiple of 128 (each is written
// whole by the first kernel).  window 0 and cap 0 mean none.  Returns
// cudaGetLastError() after the launches (a refused launch is never silent).
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
    int b, int sq, int skv, int h, int hkv, int hd, int causal, int window,
    float cap, int q_offset, int kv_len, float scale, void* stream) {
  const int sq_pad = (sq + ROWS - 1) / ROWS * ROWS;
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || h % hkv != 0 ||
      kv_len < 0 || kv_len > skv || window < 0 || q_offset < 0 ||
      sq_pad / ROWS > 65535 || (skv + KV_BK - 1) / KV_BK > 65535 ||
      hd <= 0 || hd > 256 || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{(const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
           (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
           lse, dsum, b, sq, skv, h, hkv, hd, causal, window, q_offset,
           kv_len, sq_pad, cap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 63) / 64) {
    case 1:
      return launch<64>(q, k, v, p, s);
    case 2:
      return launch<128>(q, k, v, p, s);
    case 3:
      return launch<192>(q, k, v, p, s);
    default:
      return launch<256>(q, k, v, p, s);
  }
}
