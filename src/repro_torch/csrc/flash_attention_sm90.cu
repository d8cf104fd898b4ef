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
//   o = acc / max(l, 1e-30) in bfloat16.  hd is 64, 128 or 256.
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
//   - a block of 384 threads takes 128 query rows of one (head, batch): one
//     producer warpgroup, whose first thread issues every TMA load, and two
//     consumer warpgroups of 64 rows each; setmaxnreg moves registers from
//     the producer (24 a thread) to the consumers (240 a thread), which hold
//     a 64 x hd float32 O accumulator (hd / 2 registers a thread) and the
//     64 x 64 S tile;
//   - TMA copies Q once and K and V tiles of 64 keys into a ring of two
//     stages (a full barrier each for K and for V, an empty barrier that all
//     256 consumer threads arrive on), as 64-column boxes with 128-byte
//     swizzle; keys past Skv arrive as zeros and are masked by kv_len;
//   - S = Q K^T is hd / 16 wgmma.m64n64k16 from shared memory, both
//     operands K-major; O += P V is 4 wgmma.m64n{hd}k16 that take P from
//     registers (the S accumulator converted to bf16 in place, whose layout
//     is the A operand's) and V from shared memory with the transpose bit
//     (V's tile is MN-major; its hd / 64 boxes are the descriptor's leading
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
//     last tiles do the most work.
//   A row with no kept key at all ends with m = -1e30 (a kept logit is
//   larger) and is written as 0, as csrc/flash_decode.cu gives it; in the
//   loop its masked keys weigh 1, as in the reference until a kept key
//   multiplies them by 0.  (The reference's chunk scan averages the
//   masked values for such a row, and csrc/flash_attention.cu those of the
//   edge tiles it walks; no served call has such a row.)  Masked logits
//   of -inf (p = 0 in the loop) measured slower on the H100.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                  // query rows of a consumer warpgroup
constexpr int CONSUMERS = 2;
constexpr int BQ = BM * CONSUMERS;      // query rows of a block
constexpr int BK = 64;                  // keys of a tile
constexpr int STAGES = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int BOX_Q = BM * 128;         // bytes of a 64-column box of Q rows
constexpr int BOX_KV = BK * 128;        // bytes of a 64-column box of keys
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Layout {
  static constexpr int CH = HD / 64;                 // boxes a row
  static constexpr int Q_BYTES = CONSUMERS * CH * BOX_Q;
  static constexpr int KV_BYTES = CH * BOX_KV;       // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BARS = 1 + 3 * STAGES;        // q, k[], v[], empty[]
  static constexpr int ALLOC = BAR_OFF + 8 * BARS + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_done(bar, parity)) {
  }
}
// The producer's wait: one that lasts more than two seconds (the device's
// nanosecond timer) traps, so a stalled pipeline ends the launch with an
// error and never hangs the card.  The producer waits for the consumers'
// release of every stage before it exits, so a stall anywhere reaches it.
// (The consumers' waits have no guard: a trap in their code costs the hd
// 256 accumulator a spill to local memory.)
__device__ __forceinline__ void mbar_wait_guarded(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t start, now;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(start));
  while (!mbar_done(bar, parity)) {
    asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(now));
    if (now - start > 2000000000u) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor with 128-byte swizzle: the start
// address, the leading and the stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// `desc` moved on by `bytes` (a constant): the start address is the low
// field, and no tile reaches past it.  The empty asm keeps the compiler from
// hoisting all of a loop's descriptors into registers ahead of the loop.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  asm volatile("" : "+l"(desc));
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC32_OUT                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define ACC32_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32_OUT
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N), B MN-major in
// shared memory (the transpose bit set), N = hd: 64, 128 or 256.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int sq, int h, int hkv,
                  int causal, int window, float softcap, int q_offset,
                  int kv_len, float scale) {
  using L = Layout<HD>;
  constexpr int CH = L::CH;
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
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
  // O: 8-column chunk j of the 64 x hd tile in acc[4 j .. 4 j + 3]
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;

  mbar_wait(q_full, 0);
  const uint64_t q_desc = sw128_desc(q_s + c * CH * BOX_Q, 16, 1024);
  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int k0 = t * BK;
    if (!live || k0 >= c_hi || k0 + BK <= c_lo) {
      // none of this warpgroup's rows keeps a key of the tile; waiting for
      // the tile keeps the arrival below in step with the ring's phases
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
      for (int kk = 0; kk < HD / 16; ++kk)
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
      for (int j = 0; j < HD / 8; ++j) {
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
  // kept key
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
    __nv_bfloat16* dst = o + (((int64_t)b * sq + row) * h + head) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[j * 4 + 2 * i] * l[i],
                                acc[j * 4 + 2 * i + 1] * l[i]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its entry
// point, so the kernel library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A (B, S, heads, hd) bfloat16 tensor as TMA boxes of 64 columns x `rows`
// rows of one head, with 128-byte swizzle; rows past S read as zeros.
bool make_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int b,
              int s, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)s * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int h, int hkv, int causal, int window,
           float softcap, int q_offset, int kv_len, float scale,
           cudaStream_t stream) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, enc, q, b, sq, h, HD, BM) ||
      !make_map(&tk, enc, k, b, skv, hkv, HD, BK) ||
      !make_map(&tv, enc, v, b, skv, hkv, HD, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_sm90_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HD>::ALLOC);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, (sq + BQ - 1) / BQ, b);
  kern<<<grid, THREADS, Layout<HD>::ALLOC, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, sq, h, hkv, causal, window, softcap,
      q_offset, kv_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v, o; hd 64, 128 or 256.  window 0 means none; softcap 0
// means none.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int sq, int skv, int h, int hkv,
                                           int hd, int causal, int window,
                                           float softcap, int q_offset,
                                           int kv_len, float scale,
                                           void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || h % hkv != 0 ||
      kv_len < 0 || kv_len > skv || window < 0 || h > 65535 || b > 65535 ||
      (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, b, sq, skv, h, hkv, causal, window,
                        softcap, q_offset, kv_len, scale, s);
    case 128:
      return launch<128>(q, k, v, o, b, sq, skv, h, hkv, causal, window,
                         softcap, q_offset, kv_len, scale, s);
    case 256:
      return launch<256>(q, k, v, o, b, sq, skv, h, hkv, causal, window,
                         softcap, q_offset, kv_len, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
