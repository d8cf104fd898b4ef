// Flash attention on Hopper's tensor cores (wgmma, TMA, mbarriers), bf16.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (Pallas
//   body _flash_kernel), on the bfloat16 prefill calls of the model's `mha`
//   (src/repro/models/attention.py): the `sm90` route of
//   repro_torch/kernels/flash_attention.py.  It computes the whole function
//   that csrc/flash_attention.cu computes: q (B, Sq, H, hd), k and v
//   (B, Skv, Hkv, hd) in the model's layout, query head h reading kv head
//   h / (H / Hkv); the query at row r sits at position i = q_offset + r; key
//   j is kept iff j < kv_len, (not causal or j <= i) and (window == 0 or
//   j > i - window); logits q.k * scale, with softcap > 0 cap * tanh(x /
//   cap), masked logits -1e30; online softmax with float32 (m, l, acc);
//   o = acc / max(l, 1e-30) in bfloat16.  hd is any multiple of 8 up to
//   256 (TMA's 16-byte row stride); the block computes at HP, hd rounded up
//   to 64, 128, 192 or 256 (`launch`'s switch), and the real hd stays a
//   run-time argument.
//
// Bound on the H100: operations.  A gemma2-2b global prefill layer (B 2, S
//   5000, H 8, hd 256) does 4 hd operations a kept (query, key) pair, 205
//   GFLOP, against 123 MB of q, k, v and o: 207 us at 989 TFLOP/s bf16,
//   37 us at 3.35 TB/s.  So the products must run on the tensor cores.
//
// Design (FlashAttention-3's layout, without its intra-warpgroup overlap:
// a software pipeline that ran tile t's softmax while the tensor cores did
// P V of tile t - 1 measured slower on the H100 at the global prefill, and
// was taken out):
//   - a block takes 64 query rows of one (head, batch) a consumer
//     warpgroup, beside one producer warpgroup whose first thread starts
//     every TMA load; setmaxnreg moves registers from the producer (24 a
//     thread) to the consumers, which hold a 64 x HP float32 O accumulator
//     (HP / 2 registers a thread) and the 64 x 64 S tile.  At HP 192 and
//     256 two consumers (384 threads, 240 registers a consumer thread); at
//     HP 64 and 128 three (512 threads, 160 registers), so that two
//     warpgroups' products can run while the third does its softmax: at
//     zamba2-7b's prefill (hd 112) three took 1116.49 us a call against
//     two's 1330.21, and 770.12 against 908.83 at llama's cross prefill
//     (hd 128) (chip_smoke.py phase 12, H100 80GB HBM3, 700 W); a third
//     stage of the ring, P V's wait deferred past the next tile's Q K^T,
//     tiles of 128 keys and Q K^T k-steps past hd skipped were each
//     slower there;
//   - TMA copies Q once and K and V tiles of 64 keys into a ring of two
//     stages (a full barrier each for K and for V, an empty barrier that
//     every consumer thread arrives on), as 64-column boxes with 128-byte
//     swizzle; keys past Skv arrive as zeros and are masked by kv_len;
//   - S = Q K^T is HP / 16 wgmma.m64n64k16 from shared memory, both
//     operands K-major; O += P V is 4 wgmma.m64n{HP}k16 that take P from
//     registers (the S accumulator converted to bf16 in place, whose layout
//     is the A operand's) and V from shared memory with the transpose bit
//     (V's tile is MN-major; its HP / 64 boxes are the descriptor's leading
//     dimension);
//   - the online softmax runs on the accumulator fragments in the
//     reference's order: m_new = max(m, rowmax), p = exp(s - m_new),
//     l = l corr + sum p (each thread's share; the quad's shares are summed
//     once at the end), acc = acc corr + P V.  exp is ex2.approx on logits
//     already multiplied by log2(e) (after the cap); the cap's tanh is
//     tanh.approx.f32 (about 2^-11 relative);
//   - a block walks only the key tiles that the masks reach; a tile that a
//     warpgroup's rows all drop is skipped (exact, as in the reference a
//     masked entry is multiplied by exp(-1e30 - m) = 0 once a kept key has
//     arrived), and only tiles on a mask edge evaluate the mask per element;
//   - query tiles are issued last first, since under the causal mask the
//     last tiles do the most work;
//   - at an hd below HP (80, 112, 192 ...) the tensor maps are built at the
//     real hd, so the row strides are the tensor's; the last 64-column box
//     runs past the row and TMA fills its columns with zeros (a box's bytes
//     still all count toward the barrier's transaction).  Zero columns of Q
//     and K add nothing to Q K^T, zero columns of V give O columns that the
//     epilogue never stores: it writes the hd / 8 real 8-column chunks of a
//     row.  The scale is the caller's, 1 / sqrt(hd), never 1 / sqrt(HP).
//     The padded work is HP / hd of the function's (128 / 112 at zamba2's
//     hd 112).
//   A row with no kept key at all ends with m = -1e30 (a kept logit is
//   larger) and is written as 0, as csrc/flash_decode.cu gives it; in the
//   loop its masked keys weigh 1, as in the reference until a kept key
//   multiplies them by 0.  (The reference's chunk scan averages the
//   masked values for such a row, and csrc/flash_attention.cu those of the
//   edge tiles it walks; no served call has such a row.)  Masked logits
//   of -inf (p = 0 in the loop) measured slower on the H100.
#include "sm90_wgmma.cuh"

namespace {

constexpr int BM = 64;                  // query rows of a consumer warpgroup
constexpr int BK = 64;                  // keys of a tile
constexpr int STAGES = 2;
constexpr int BOX_Q = BM * 128;         // bytes of a 64-column box of Q rows
constexpr int BOX_KV = BK * 128;        // bytes of a 64-column box of keys
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HP>
struct Layout {
  // three consumer warpgroups where their accumulators fit in 160
  // registers a thread (HP <= 128), else two with 240
  static constexpr int CONSUMERS = HP <= 128 ? 3 : 2;
  static constexpr int BQ = BM * CONSUMERS;          // query rows of a block
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int REGS = CONSUMERS == 3 ? 160 : 240;  // a consumer thread
  static constexpr int CH = HP / 64;                 // boxes a row
  static constexpr int Q_BYTES = CONSUMERS * CH * BOX_Q;
  static constexpr int KV_BYTES = CH * BOX_KV;       // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BARS = 1 + 3 * STAGES;        // q, k[], v[], empty[]
  static constexpr int ALLOC = BAR_OFF + 8 * BARS + 1024;  // + alignment
};

template <int HP>
__global__ void __launch_bounds__(Layout<HP>::THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int sq, int h, int hkv,
                  int hd, int causal, int window, float softcap,
                  int q_offset, int kv_len, float scale) {
  using L = Layout<HP>;
  constexpr int CH = L::CH, CONSUMERS = L::CONSUMERS, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t k_full = q_full + 8;                 // + 8 s
  const uint32_t v_full = k_full + 8 * STAGES;        // + 8 s
  const uint32_t empty = v_full + 8 * STAGES;         // + 8 s

  const int head = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tile first
  const int khead = head / (h / hkv);
  // the key tiles that any row of the block keeps
  const int first = q_offset + q0;
  const int last = q_offset + min(q0 + BQ, sq) - 1;
  int hi = kv_len, lo = 0;
  if (causal) hi = min(hi, last + 1);
  if (window > 0) lo = max(0, first - window + 1);
  const int t_lo = lo / BK;
  const int t_hi = hi > lo ? (hi + BK - 1) / BK : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < CONSUMERS; ++c)
        for (int ch = 0; ch < CH; ++ch)
          tma_load_4d(q_s + (c * CH + ch) * BOX_Q, &tq, q_full, ch * 64,
                      head, q0 + c * BM, b);
      int it = 0;
      for (int t = t_lo; t < t_hi; ++t, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          mbar_wait_guarded(empty + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, L::KV_BYTES);
        for (int ch = 0; ch < CH; ++ch)
          tma_load_4d(k_s + s * L::KV_BYTES + ch * BOX_KV, &tk,
                      k_full + 8 * s, ch * 64, khead, t * BK, b);
        mbar_expect_tx(v_full + 8 * s, L::KV_BYTES);
        for (int ch = 0; ch < CH; ++ch)
          tma_load_4d(v_s + s * L::KV_BYTES + ch * BOX_KV, &tv,
                      v_full + 8 * s, ch * 64, khead, t * BK, b);
      }
      // the consumers' release of the last tiles
      for (int j = max(0, it - STAGES); j < it; ++j)
        mbar_wait_guarded(empty + 8 * (j % STAGES), (j / STAGES) & 1);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::REGS));
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + c * BM + warp * 16 + lane / 4;   // and row0 + 8
  const int pos0 = q_offset + row0;
  const bool live = q0 + c * BM < sq;
  // this warpgroup's key range, and where its mask has an edge
  const int c_first = q_offset + q0 + c * BM, c_last = c_first + BM - 1;
  const int c_hi = causal ? min(kv_len, c_last + 1) : kv_len;
  const int c_lo = window > 0 ? max(0, c_first - window + 1) : 0;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

  float m[2] = {NEG_INF, NEG_INF};   // running max, in log2 units
  float l[2] = {0.0f, 0.0f};         // this thread's share of the row sums
  // O: 8-column chunk j of the 64 x HP tile in acc[4 j .. 4 j + 3]
  float acc[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) acc[i] = 0.0f;

  mbar_wait(q_full, 0);
  const uint64_t q_desc = sw128_desc(q_s + c * CH * BOX_Q, 16, 1024);
  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int k0 = t * BK;
    if (!live || k0 >= c_hi || k0 + BK <= c_lo) {
      // none of this warpgroup's rows keeps a key of the tile; it still
      // waits for both of its loads, so that the arrival below and its
      // next parity waits stay in step with the ring's phases: a wait on
      // a K barrier whose previous phase this warpgroup skipped would pass
      // on that phase's parity while its K is still in flight (behind a
      // window a warpgroup skips a stage's first tiles), and Q K^T would
      // read a K tile being written
      mbar_wait(k_full + 8 * s, parity);
      mbar_wait(v_full + 8 * s, parity);
    } else {
      const uint64_t k_desc = sw128_desc(k_s + s * L::KV_BYTES, 16, 1024);
      const uint64_t v_desc =
          sw128_desc(v_s + s * L::KV_BYTES, BOX_KV, 1024);
      mbar_wait(k_full + 8 * s, parity);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk)
        wgmma_ss(sc, desc_at(q_desc, (kk / 4) * BOX_Q + (kk % 4) * 32),
                 desc_at(k_desc, (kk / 4) * BOX_KV + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);

      // scale, cap and mask, in log2 units
      const bool edge = !(k0 + BK <= kv_len &&
                          (!causal || k0 + BK - 1 <= c_first) &&
                          (window == 0 || k0 > c_last - window));
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float x = sc[cc * 4 + i * 2 + j] * scale;
            if (softcap > 0.0f) x = softcap * tanh_approx(x * inv_cap);
            x *= LOG2E;
            if (edge) {
              const int key = k0 + cc * 8 + 2 * (lane % 4) + j;
              const int pos = pos0 + 8 * i;
              bool keep = key < kv_len;
              if (causal) keep = keep && key <= pos;
              if (window > 0) keep = keep && key > pos - window;
              x = keep ? x : NEG_INF;
            }
            sc[cc * 4 + i * 2 + j] = x;
          }
      // online softmax on the fragments: a row is spread over a quad
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          mx = fmaxf(mx, fmaxf(sc[cc * 4 + i * 2], sc[cc * 4 + i * 2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        corr[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = ex2(sc[cc * 4 + i * 2 + j] - m_new);
            sc[cc * 4 + i * 2 + j] = p;
            sum += p;
          }
        l[i] = l[i] * corr[i] + sum;
      }
#pragma unroll
      for (int j = 0; j < HP / 8; ++j) {
        acc[j * 4 + 0] *= corr[0];
        acc[j * 4 + 1] *= corr[0];
        acc[j * 4 + 2] *= corr[1];
        acc[j * 4 + 3] *= corr[1];
      }
      // P as the A operand: k-step kk takes S columns 16 kk .. 16 kk + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      mbar_wait(v_full + 8 * s, parity);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, pa[kk], desc_at(v_desc, kk * 2048));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
    }
    mbar_arrive(empty + 8 * s);
  }

  // o = acc / max(l, 1e-30), the quad's shares of l summed first (one
  // reciprocal a row, not a division an element: IEEE division has a slow
  // path that the compiler calls as a subroutine, and the accumulator
  // would be saved to local memory around each call); 0 for a row with no
  // kept key.  Only the real hd columns are stored: the chunks past hd
  // hold the zero columns of V (and would land in the next head's row).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = m[i] == NEG_INF ? 0.0f : __frcp_rn(fmaxf(l[i], 1e-30f));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* dst = o + (((int64_t)b * sq + row) * h + head) * hd;
#pragma unroll
    for (int j = 0; j < HP / 8; ++j)
      if (j * 8 < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + 2 * (lane % 4)) =
            __floats2bfloat162_rn(acc[j * 4 + 2 * i] * l[i],
                                  acc[j * 4 + 2 * i + 1] * l[i]);
  }
}

template <int HP>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int h, int hkv, int hd, int causal, int window,
           float softcap, int q_offset, int kv_len, float scale,
           cudaStream_t stream) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  // the maps at the real hd: the boxes past it read as zeros
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, enc, q, b, sq, h, hd, BM) ||
      !make_map(&tk, enc, k, b, skv, hkv, hd, BK) ||
      !make_map(&tv, enc, v, b, skv, hkv, hd, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_sm90_kernel<HP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HP>::ALLOC);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = Layout<HP>::BQ;
  dim3 grid(h, (sq + BQ - 1) / BQ, b);
  kern<<<grid, Layout<HP>::THREADS, Layout<HP>::ALLOC, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, sq, h, hkv, hd, causal, window, softcap,
      q_offset, kv_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v, o; hd a multiple of 8 up to 256, computed at the next
// multiple of 64.  window 0 means none; softcap 0 means none; scale is
// 1 / sqrt(hd).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int sq, int skv, int h, int hkv,
                                           int hd, int causal, int window,
                                           float softcap, int q_offset,
                                           int kv_len, float scale,
                                           void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || h % hkv != 0 ||
      kv_len < 0 || kv_len > skv || window < 0 || h > 65535 || b > 65535 ||
      (sq + 127) / 128 > 65535 || hd <= 0 || hd > 256 || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((hd + 63) / 64) {
    case 1:
      return launch<64>(q, k, v, o, b, sq, skv, h, hkv, hd, causal, window,
                        softcap, q_offset, kv_len, scale, s);
    case 2:
      return launch<128>(q, k, v, o, b, sq, skv, h, hkv, hd, causal, window,
                         softcap, q_offset, kv_len, scale, s);
    case 3:
      return launch<192>(q, k, v, o, b, sq, skv, h, hkv, hd, causal, window,
                         softcap, q_offset, kv_len, scale, s);
    default:
      return launch<256>(q, k, v, o, b, sq, skv, h, hkv, hd, causal, window,
                         softcap, q_offset, kv_len, scale, s);
  }
}
