// Flash attention forward (causal, GQA, sliding window) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/attn_kernel.py::_flash_kernel
// (wrapper flash_attention at attn_kernel.py:80, pallas_call at :113):
//     q (B, Sq, H, d), k and v (B, Sk, Hkv, d), float32 or bfloat16
//     o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] / sqrt(d)) v[b, j, g]
//     with g = h / (H / Hkv), over the keys j < Sk with j <= i (causal) and
//     j > i - window (window != 0); arithmetic in float32, o in q's type.
// A query row that no key is left to (only possible with a window) gets
// the oracle's result (src/repro/kernels/ref.py::flash_attention): the
// softmax of equal scores, 1/Sk times the sum of v over all Sk keys.
//
// The bound of the function on the card in bfloat16: bytes (float32:
// below).  At whisper-large-v3's decoder shape (4, 384, 20, 64) bf16,
// causal, it reads q, k and v once and writes o once, 15.7 MB: 4.7 us at
// 3.35 TB/s.  Its products are 1.5
// GFLOP of causal q.k and p.v; with p.v taken as three bf16 products
// (below) the tensor cores do about 3.0 GFLOP, 3.1 us at the 989 TFLOP/s
// bf16 peak, so the bound stays the bytes.
//
// Both kernels take a block per (query tile of 64 rows, head, batch row),
// visit only the 64-key tiles that can hold a valid key for one of the
// block's rows (tile_range), keep the running max, sum and output in
// registers, and read q, k and v in place in the (B, S, H, d) layout from
// their element strides (d contiguous), with no transposed copy in device
// memory.  The masked scores are -inf and their probabilities exactly 0,
// so a tile with no valid key for a row adds nothing (the Pallas kernel
// lets such a tile add exp(0) terms until a real tile rescales them away).
//
// Head dims: every positive multiple of 8, which is what the reference's
// routing admits (src/repro/models/common.py:185-188) and its Pallas
// kernel runs ((1, 1, block, d) BlockSpecs).  The bf16 kernel is
// instantiated at D = 32, 64 and 128, and D serves every d in (the
// previous D, D] on tiles zero past d: its tensor maps span the real d, so
// TMA's out-of-bounds fill gives zero columns of q, k and v and its store
// clips o's columns past d (the float32 kernel's too).  Zero columns change neither q.k nor o's first
// d columns, and the scale is 1/sqrt(d) of the real d, passed at run time.
// Past d = 128 a block owns 128 output columns (column blocks on the
// grid): it takes q.k over the whole d in chunks and then p.v over its
// 128 columns of v, so d has no upper limit, at the cost of the scores
// once a column block; flash_fwd_wgmma_cols_kernel streams 64-column
// chunks of q and k through its TMA ring.  Not a D = 256 bf16
// instantiation: its accumulator alone would be 128 registers a thread
// beside the scores and the split of p (the D = 128 kernel already takes
// 165), past the 255 a thread has without spilling, and its q tile and two
// stages of k and v would fill 160 KB, one block a multiprocessor.  The
// float32 kernel streams q.k in 32-column chunks for every d and owns D =
// 32 output columns up to d = 32, else 64, in column blocks past 64.
//
// bfloat16 (the model path), flash_fwd_wgmma_kernel: a block of 160
// threads, one consumer warpgroup (warps 0-3, 64 query rows, 16 a warp)
// and one producer warp (warp 4).
//   - Loads: the producer's lane 0 issues TMA loads (cp.async.bulk.tensor)
//     from tensor maps over the (d, H, S, B) view, encoded on the host: the
//     block's q tile once, then the k and v tiles of its key range into a
//     ring of stages (4 at d = 32, 2 at d = 64 and 128), each with a full
//     mbarrier (the bytes landed) and an empty one (the 128 consumers are
//     done with it), so the next tile loads while this one is computed.
//     TMA's zero fill stands for the rows past Sq and Sk.  Tiles are stored
//     in TMA's 128-byte swizzle (d = 64; d = 128 as two 64-column blocks)
//     or 64-byte swizzle (d = 32), the layouts the wgmma shared-memory
//     descriptors read.
//   - S = q.k^T: wgmma m64n64k16, q and k both K-major from shared memory,
//     d / 16 steps, float32 accumulators.
//   - Softmax: masks only on tiles that cross the causal diagonal, the
//     window's edge or Sk's ragged end; 1/sqrt(d) folded into the exp2
//     argument (scores times log2(e)/sqrt(d), which differs from the plain
//     version's division at float32 rounding; at d = 64 the 1/8 is exact).
//     A row's max and sum cross the four lanes that hold it by xor-shuffles.
//   - O += p.v: wgmma m64nDk16 with p from registers (the accumulator
//     layout of S is, per warp, the register layout of A, so p never
//     leaves registers) and the v tile from shared memory read MN-major
//     (the transpose bit of 16-bit types).  The reference computes p.v in
//     float32 (attn_kernel.py:57-60), so each float32 probability is split
//     exactly into three bf16 pieces (its top 8 significant bits, the next
//     8, the last 8: a truncation split, three byte permutes and no
//     conversion instruction) and three wgmmas (lo, mid, hi) accumulate
//     into the same float32 O: the arithmetic stays float32 to rounding,
//     at three times p.v's tensor work, which stays under the byte bound.
//   - Epilogue: O times 1/l rounded once to bf16, staged in the q tile's
//     shared memory in the same swizzle and written by a TMA store, which
//     clips the rows past Sq.
//   - Grid (H, B, query tiles), the tiles walked from the last, so the
//     longest causal rows of every head start first.  Shared memory, all
//     dynamic: 128 * d bytes a tile, q plus two tiles a stage, 8 bytes an
//     mbarrier and 1 KB to align the swizzle atoms to 1024 bytes: 37960 /
//     42024 / 82984 bytes at d = 32 / 64 / 128 (d = 128 opts in above
//     48 KB).  Registers bound the blocks an SM holds: three at d <= 64
//     (__launch_bounds__ caps a thread at 136), two at d = 128.
//   - What bounds it on the card at whisper's shape: not the bytes but
//     each block's serial chain (TMA latency for the first tiles, then per
//     tile the scores' wgmma, the softmax and split on the ALU and MUFU
//     pipes, and the three p.v wgmmas), with the longest causal blocks (6
//     key tiles) setting the kernel's time (PERF.md, section 6).
// float32, flash_fwd_tf32_kernel<D> (no model path at full width; the
// reduced whisper in float32): both products on the tensor cores in tf32,
// split so that the arithmetic stays float32 (the reference computes both
// in float32, attn_kernel.py:57-60; one tf32 pass keeps 11 significant
// bits).  Each factor x = hi + lo, hi = tf32(x), lo = tf32(x - hi), tf32
// the nearest (an add and a mask), and each product is lo.hi + hi.lo +
// hi.hi (3xTF32: the dropped lo.lo term and lo's rounding are near 2^-22
// of the product), three wgmmas into the same float32 accumulator, small
// terms first.  The same block of a consumer warpgroup and a producer warp
// as the bf16 kernel, with its tile_range, reverse tile order, masks,
// online softmax and epilogue; D = 32 output columns a block up to d = 32,
// else 64, in column blocks of 64 past 64 (D = 128 takes the scores once
// for d <= 128 but fits one block a multiprocessor, and measured slower at
// d = 96: PERF.md).
//   - Loads: TMA boxes of 64 rows x 32 floats (one 128-byte swizzled row
//     each) through a ring of stages of two boxes (4 at D = 32, 3 at 64):
//     per key tile the producer loads ceil(d / 32) items of a q chunk and
//     a k chunk, then an item of v's block columns.  q is reloaded (from L2) with every key tile: held whole
//     with its low part it would take 2 x 64 x d x 4 bytes a block.
//   - S = q.k^T: the consumers split a chunk's q and k in place into their
//     high parts and, through registers, into a buffer of low parts,
//     element by element (the swizzle carries over), then wgmma m64n64k8
//     with both operands K-major from shared memory (d contiguous), 4 steps
//     a chunk, 3 wgmmas a step.  A chunk's loads, split and high parts run
//     while the last chunk's wgmmas do; only its low parts wait for them.
//   - p.v: wgmma's tf32 form reads shared-memory operands K-major only and
//     has no transpose bit, and v's tile is (keys, d) with d contiguous,
//     MN-major.  So the consumers write each v tile transposed, as v^T's
//     high and low parts (D rows of 64 keys, 128-byte swizzle), an O(64 *
//     D) pass against O(64 * 64 * D) of products, while the last chunk's
//     wgmmas run.  p stays in registers as the A operand: the
//     accumulator layout of S holds keys 2tg and 2tg + 1 of each 8, where
//     the tf32 A fragment wants positions tg and tg + 4, so v^T's rows
//     store the keys of each 8 in that order (key 8g + 2i + e at position
//     8g + i + 4e) and p needs no shuffle.
//   - Shared memory (F32Tile<D>::kSmem: stages, the low-part buffer, v^T's
//     two parts, barriers, 1 KB to align): 99392 / 99376 bytes at D = 32 /
//     64, two blocks a multiprocessor; every tile is 1024-byte aligned for
//     the swizzle atoms.
//   - What bounds it on the card: at (4, 384, 20, d) causal, reading q, k
//     and v once and writing o once takes 9.4 us at d = 64 (14.1 at 96,
//     37.6 at 256) at 3.35 TB/s, and the products, 3 x 4d per (query,
//     key) pair at the 494.7 TFLOP/s tf32 peak, 9.2 us (13.8, 36.7).
//     The kernel adds a serial chain per tile in each block (the split on
//     the ALU pipes, the score wgmmas, the softmax, v's transpose, the p.v
//     wgmmas), the zero columns of a partial chunk or column block, and
//     the scores once a column block past 64; its time follows that
//     chain, not its products (PERF.md, section 6).
//
// Built without -fmad=false (see runtime.py): the scores and the output
// are sums of d and Sk products with no bit-for-bit contract with the
// reference, and a fused multiply-add rounds once where a multiply and an
// add round twice.  The division by the row sum is IEEE (no fast math);
// exp2 is the hardware's ex2.approx (2 ulp), the scale 1/sqrt(d) folded
// into its argument, in both kernels.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "plan.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kConsumers = 128;              // one warpgroup, 64 rows
constexpr int kWgThreads = kConsumers + 32;  // ... and the producer warp

struct Strides {  // element strides of a (B, S, heads, d) operand
  long long b, s, h;
};

// The key tiles [t_begin, t_end) that can hold a valid key for some query
// row of the block: causal rows end at the block's last row, a window
// starts at its first row's window.
struct TileRange {
  int t_begin, t_end;
};

__device__ __forceinline__ TileRange tile_range(int iq, int sq, int sk,
                                                int causal, int window) {
  const int q_lo = iq * kBQ, q_hi = min(sq, q_lo + kBQ) - 1;
  const int key_end = causal ? min(sk, q_hi + 1) : sk;
  int key_begin = 0;
  if (window != 0) {
    const long long kb0 = static_cast<long long>(q_lo) - window + 1;
    key_begin = kb0 <= 0 ? 0 : (kb0 >= sk ? sk : static_cast<int>(kb0));
  }
  return {key_begin / kBK, (key_end + kBK - 1) / kBK};
}

__device__ __forceinline__ bool key_valid(int j, int i, int sk, int causal,
                                          int window) {
  return j < sk && (!causal || j <= i) &&
         (window == 0 ||
          static_cast<long long>(j) > static_cast<long long>(i) - window);
}

// ---------------------------------------------------------------------------
// bfloat16: TMA ring, wgmma for both products
// ---------------------------------------------------------------------------

// The shared-memory tiles of head dim D: 64 rows (kBQ queries or kBK
// keys) of D bf16, stored as column blocks of kW columns, each in the
// swizzle of its kW * 2-byte rows (the TMA box is one column block).
template <int D>
struct Tile {
  static constexpr int kW = D < 64 ? D : 64;            // columns of a block
  static constexpr int kRowBytes = 2 * kW;              // 64 or 128: the swizzle
  static constexpr int kBlockBytes = kBQ * kRowBytes;   // one column block
  static constexpr int kBlocks = D / kW;                // 1, 1, 2
  static constexpr int kBytes = kBlocks * kBlockBytes;  // 128 * D
  static constexpr int kStages = D == 32 ? 4 : 2;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  // q, then (k, v) per stage, then the mbarriers (q_full, full[s],
  // empty[s]), after 1024 bytes of room to align the base
  static constexpr long long kSmem =
      1024 + static_cast<long long>(kBytes) * (1 + 2 * kStages) + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Arrive on `bar` and expect `bytes` more from TMA before its phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box of `map` at coordinates (c0, c1, c2, c3) = (column, head,
// row, batch) into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: shared memory at `src` to the box of `map` at (c0, c1, c2, c3).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type (the swizzle).  K-major (q, k):
// the leading offset is unused, the stride one is 8 rows.  MN-major (v):
// the leading offset steps from one 64-column block to the next, the
// stride one over 8 keys.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead, uint32_t stride,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// d (64 x 64 float32, the accumulator layout) = a . b^T, or += with accumulate;
// a (64 x 16) and b (64 x 16) K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32 float32) += a . b: a (64 x 16 bf16) in registers in the
// accumulator-derived layout, b (16 x 32) MN-major in shared memory
// (transposed read).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64 float32) += a . b: a (64 x 16 bf16) in registers in the
// accumulator-derived layout, b (16 x 64) MN-major in shared memory
// (transposed read).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 float32) += a . b: a (64 x 16 bf16) in registers in the
// accumulator-derived layout, b (16 x 128) MN-major in shared memory
// (transposed read).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Two float32 values as three bf16 pairs with x = hi + mid + lo exactly:
// hi keeps x's top 8 significant bits (x truncated to bf16), mid the next
// 8 of the exact residual x - hi, lo the rest, which has at most 8
// significant bits left and is a bf16 value itself.  Each piece is the
// upper half of a float32, so a pair packs with one byte permute (the
// lower key in the lower 16 bits) and no conversion instruction.
__device__ __forceinline__ float top8(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_upper(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const float r0 = x0 - top8(x0), r1 = x1 - top8(x1);
  hi = pack_upper(x0, x1);
  mid = pack_upper(r0, r1);
  lo = pack_upper(r0 - top8(r0), r1 - top8(r1));
}

// One block: 64 query rows of one (batch row, head); see the header.
// Three blocks an SM at d <= 64 (at most 136 registers a thread; ptxas
// fits d = 32 and 64 without spilling), two at d = 128 (a third would
// spill).
template <int D>
__global__ void __launch_bounds__(kWgThreads, D == 128 ? 2 : 3)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map,
                       const __nv_bfloat16* __restrict__ v, Strides vs, int sq, int sk,
                       int rep, int causal, int window, int d, float scale) {
  using T = Tile<D>;
  constexpr int kS = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  uint8_t* const tile0 = smem_raw + (base - raw);  // q's tile, later o's
  const uint32_t q_full = base + T::kBytes * (1 + 2 * kS);
  // stage s: k at kv(s), v at kv(s) + T::kBytes; barriers full(s), empty(s)
  auto kv = [&](int s) { return base + T::kBytes * (1 + 2 * s); };
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + kS + s); };

  const int h = blockIdx.x, b = blockIdx.y, iq = gridDim.z - 1 - blockIdx.z;
  const int g = h / rep, q0 = iq * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TileRange tr = tile_range(iq, sq, sk, causal, window);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_full, T::kBytes);
      for (int c = 0; c < T::kBlocks; ++c)
        tma_load(&q_map, base + c * T::kBlockBytes, q_full, c * T::kW, h, q0, b);
      for (int t = tr.t_begin, i = 0; t < tr.t_end; ++t, ++i) {
        const int s = i % kS;
        if (i >= kS) mbar_wait(empty(s), (i / kS - 1) & 1);
        mbar_expect_tx(full(s), 2 * T::kBytes);
        for (int c = 0; c < T::kBlocks; ++c) {
          tma_load(&k_map, kv(s) + c * T::kBlockBytes, full(s), c * T::kW, g, t * kBK, b);
          tma_load(&v_map, kv(s) + T::kBytes + c * T::kBlockBytes, full(s), c * T::kW, g,
                   t * kBK, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup; this thread's rows: row0 and row0 + 8
  const int grp = lane >> 2, tg = lane & 3;
  const int row0 = q0 + warp * 16 + grp;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  // running max (of the raw scores) and this thread's share of the row sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  mbar_wait(q_full, 0);
  for (int t = tr.t_begin, i = 0; t < tr.t_end; ++t, ++i) {
    const int s = i % kS;
    mbar_wait(full(s), (i / kS) & 1);
    const uint32_t k_tile = kv(s), v_tile = kv(s) + T::kBytes;

    // scores: 64 rows x 64 keys, p[4j + e] at (row0 + 8 (e >> 1), key 8j + 2tg + (e & 1))
    float p[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / (T::kW / 16)) * T::kBlockBytes + (kk % (T::kW / 16)) * 32;
      wgmma_ss(p, desc(base + off, 16, 8 * T::kRowBytes, T::kLayout),
               desc(k_tile + off, 16, 8 * T::kRowBytes, T::kLayout), kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs(p);

    const int j0 = t * kBK;
    const bool edge = j0 + kBK > sk || (causal && j0 + kBK - 1 > q0) ||
                      (window != 0 && static_cast<long long>(j0) <=
                                          static_cast<long long>(q0) + kBQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!key_valid(j0 + 8 * j + 2 * tg + (e & 1), row0 + 8 * (e >> 1), sk, causal,
                         window))
            p[4 * j + e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], p[j]);
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // equal maxima (both -inf before any valid key) leave the sums as they are
      alpha[r] = m_new == m[r] ? 1.0f : ex2((m[r] - m_new) * scale);
      ms[r] = m_new == -INFINITY ? 0.0f : m_new * scale;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      p[j] = ex2(fmaf(p[j], scale, -ms[(j >> 1) & 1]));
      l[(j >> 1) & 1] += p[j];
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

    // O += p.v, 16 keys a step, p in three exact bf16 pieces; the pairs of
    // p[8kk..8kk+7] are the four a registers of step kk
    uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split3(p[8 * kk + 2 * f], p[8 * kk + 2 * f + 1], hi[kk][f], mid[kk][f], lo[kk][f]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = desc(v_tile + kk * 16 * T::kRowBytes, T::kBlockBytes,
                               8 * T::kRowBytes, T::kLayout);
      wgmma_rs(o, lo[kk], vd);
      wgmma_rs(o, mid[kk], vd);
      wgmma_rs(o, hi[kk], vd);
    }
    wgmma_commit_and_wait();
    fence_regs(o);
    mbar_arrive(empty(s));
  }

  // the row sums over the four lanes of each row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // rows left with no valid key: 1/Sk times the sum of v over all keys,
  // this thread's columns read from device memory (a rare path)
  const bool empty_row[2] = {row0 < sq && l[0] == 0.0f, row0 + 8 < sq && l[1] == 0.0f};
  if (empty_row[0] || empty_row[1]) {
    const float inv = 1.0f / static_cast<float>(sk);
    const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;
    float sum[D / 4];
#pragma unroll
    for (int c = 0; c < D / 4; ++c) sum[c] = 0.0f;
    for (int j = 0; j < sk; ++j) {
      const __nv_bfloat16* vr = vb + static_cast<long long>(j) * vs.s + 2 * tg;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        if (8 * c < d) {  // d is a multiple of 8: the 8 columns are all in or all out
          sum[2 * c] += inv * __bfloat162float(vr[8 * c]);
          sum[2 * c + 1] += inv * __bfloat162float(vr[8 * c + 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!empty_row[r]) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c + 2 * r] = sum[2 * c];
        o[4 * c + 2 * r + 1] = sum[2 * c + 1];
      }
      l[r] = 1.0f;
    }
  }

  // o / l in bf16 into q's tile (every wgmma of the warpgroup has read it)
  // in the tensor map's swizzle, then one TMA store per column block
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + grp + 8 * r;
    const float inv_l = 1.0f / l[r];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * tg;
      const uint32_t off = row * T::kRowBytes + (col % T::kW) * 2;
      const uint32_t at = (col / T::kW) * T::kBlockBytes +
                          (off ^ (((off >> 7) & (T::kRowBytes / 16 - 1)) << 4));
      *reinterpret_cast<__nv_bfloat162*>(tile0 + at) =
          __floats2bfloat162_rn(o[4 * c + 2 * r] * inv_l, o[4 * c + 2 * r + 1] * inv_l);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  if (tid == 0) {
    for (int c = 0; c < T::kBlocks; ++c)
      tma_store(&o_map, base + c * T::kBlockBytes, c * T::kW, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// The column-block kernel (head dims past the largest Tile): a block owns
// DV = 128 output columns of 64 query rows, and q.k runs over the whole d
// in chunks of 64 columns streamed through the stage ring.  Every stage is
// two 64 x 64 bf16 boxes in the 128-byte swizzle (8 KB each): a chunk of q
// and the same chunk of k for a step of the scores, or the block's two
// 64-column halves of v for p.v.  Per key tile the producer loads the
// ceil(d / 64) score items, then the v item.
constexpr int kChunkCols = 64;                      // columns of a q/k chunk and of a v half
constexpr int kBoxBytes = kBQ * 2 * kChunkCols;     // one 64 x 64 bf16 box
constexpr int kColStages = 4;
constexpr long long kColSmem = 1024 + 2LL * kBoxBytes * kColStages + 8 * 2 * kColStages;

// One block: 64 query rows of one (batch row, head) and DV output columns
// of d; see the header.  Registers and barriers as flash_fwd_wgmma_kernel<128>.
template <int DV>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_fwd_wgmma_cols_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap o_map,
                            const __nv_bfloat16* __restrict__ v, Strides vs, int sq, int sk,
                            int rep, int causal, int window, int d, int nb, float scale) {
  static_assert(DV == 2 * kChunkCols, "a block's columns are two 64-column halves");
  constexpr int kS = kColStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  uint8_t* const stage0 = smem_raw + (base - raw);  // stage 0, later o's tile
  auto stage = [&](int s) { return base + 2 * kBoxBytes * s; };
  const uint32_t bars = base + 2 * kBoxBytes * kS;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kS + s); };

  const int h = blockIdx.x / nb, col0 = (blockIdx.x % nb) * DV;
  const int b = blockIdx.y, iq = gridDim.z - 1 - blockIdx.z;
  const int g = h / rep, q0 = iq * kBQ;
  const int nkc = (d + kChunkCols - 1) / kChunkCols;  // score items a key tile
  const bool upper = col0 + kChunkCols < d;  // the block's second half holds columns of d
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TileRange tr = tile_range(iq, sq, sk, causal, window);

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int t = tr.t_begin; t < tr.t_end; ++t) {
        for (int c = 0; c <= nkc; ++c, ++it) {
          const int s = it % kS;
          if (it >= kS) mbar_wait(empty(s), (it / kS - 1) & 1);
          if (c < nkc) {
            mbar_expect_tx(full(s), 2 * kBoxBytes);
            tma_load(&q_map, stage(s), full(s), c * kChunkCols, h, q0, b);
            tma_load(&k_map, stage(s) + kBoxBytes, full(s), c * kChunkCols, g, t * kBK, b);
          } else {
            mbar_expect_tx(full(s), (upper ? 2 : 1) * kBoxBytes);
            tma_load(&v_map, stage(s), full(s), col0, g, t * kBK, b);
            if (upper)
              tma_load(&v_map, stage(s) + kBoxBytes, full(s), col0 + kChunkCols, g, t * kBK, b);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup; this thread's rows: row0 and row0 + 8
  const int grp = lane >> 2, tg = lane & 3;
  const int row0 = q0 + warp * 16 + grp;
  float o[2][32];  // the two 64-column halves of the block's output
#pragma unroll
  for (int i = 0; i < 32; ++i) o[0][i] = o[1][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  int it = 0;
  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    // scores over d, a 64-column chunk a stage
    float p[32];
    for (int c = 0; c < nkc; ++c, ++it) {
      const int s = it % kS;
      mbar_wait(full(s), (it / kS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunkCols / 16; ++kk) {
        wgmma_ss(p, desc(stage(s) + kk * 32, 16, 8 * 128, 1),
                 desc(stage(s) + kBoxBytes + kk * 32, 16, 8 * 128, 1), c > 0 || kk > 0);
      }
      wgmma_commit_and_wait();
      fence_regs(p);
      mbar_arrive(empty(s));
    }

    const int j0 = t * kBK;
    const bool edge = j0 + kBK > sk || (causal && j0 + kBK - 1 > q0) ||
                      (window != 0 && static_cast<long long>(j0) <=
                                          static_cast<long long>(q0) + kBQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!key_valid(j0 + 8 * j + 2 * tg + (e & 1), row0 + 8 * (e >> 1), sk, causal,
                         window))
            p[4 * j + e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], p[j]);
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m_new == m[r] ? 1.0f : ex2((m[r] - m_new) * scale);
      ms[r] = m_new == -INFINITY ? 0.0f : m_new * scale;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      p[j] = ex2(fmaf(p[j], scale, -ms[(j >> 1) & 1]));
      l[(j >> 1) & 1] += p[j];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o[0][j] *= alpha[(j >> 1) & 1];
      o[1][j] *= alpha[(j >> 1) & 1];
    }

    uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split3(p[8 * kk + 2 * f], p[8 * kk + 2 * f + 1], hi[kk][f], mid[kk][f], lo[kk][f]);
    }
    const int s = it % kS;
    mbar_wait(full(s), (it / kS) & 1);
    fence_regs(o[0]);
    fence_regs(o[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf == 1 && !upper) continue;  // the same for the whole warpgroup
        const uint64_t vd = desc(stage(s) + hf * kBoxBytes + kk * 16 * 128, kBoxBytes,
                                 8 * 128, 1);
        wgmma_rs(o[hf], lo[kk], vd);
        wgmma_rs(o[hf], mid[kk], vd);
        wgmma_rs(o[hf], hi[kk], vd);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(o[0]);
    fence_regs(o[1]);
    mbar_arrive(empty(s));
    ++it;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // rows left with no valid key: 1/Sk times the sum of v over all keys,
  // this thread's columns of the block read from device memory
  const bool empty_row[2] = {row0 < sq && l[0] == 0.0f, row0 + 8 < sq && l[1] == 0.0f};
  if (empty_row[0] || empty_row[1]) {
    const float inv = 1.0f / static_cast<float>(sk);
    const __nv_bfloat16* vb = v + b * vs.b + g * vs.h + col0;
    float sum[DV / 4];
#pragma unroll
    for (int c = 0; c < DV / 4; ++c) sum[c] = 0.0f;
    for (int j = 0; j < sk; ++j) {
      const __nv_bfloat16* vr = vb + static_cast<long long>(j) * vs.s + 2 * tg;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        if (col0 + 8 * c < d) {
          sum[2 * c] += inv * __bfloat162float(vr[8 * c]);
          sum[2 * c + 1] += inv * __bfloat162float(vr[8 * c + 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!empty_row[r]) continue;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        o[c / 8][4 * (c % 8) + 2 * r] = sum[2 * c];
        o[c / 8][4 * (c % 8) + 2 * r + 1] = sum[2 * c + 1];
      }
      l[r] = 1.0f;
    }
  }

  // o / l in bf16 into stage 0 (every wgmma of the warpgroup has read the
  // ring, and the producer has no load left) in the 128-byte swizzle, then
  // a TMA store per half that holds columns of d
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + grp + 8 * r;
    const float inv_l = 1.0f / l[r];
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      const int col = 8 * c + 2 * tg;
      const uint32_t off = row * 128 + (col % kChunkCols) * 2;
      const uint32_t at = (col / kChunkCols) * kBoxBytes + (off ^ (((off >> 7) & 7) << 4));
      *reinterpret_cast<__nv_bfloat162*>(stage0 + at) = __floats2bfloat162_rn(
          o[c / 8][4 * (c % 8) + 2 * r] * inv_l, o[c / 8][4 * (c % 8) + 2 * r + 1] * inv_l);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  if (tid == 0) {
    tma_store(&o_map, base, col0, h, q0, b);
    if (upper) tma_store(&o_map, base + kBoxBytes, col0 + kChunkCols, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// float32: TMA ring, wgmma in tf32 for both products (3xTF32)
// ---------------------------------------------------------------------------

// Every float32 tile is made of boxes of 64 rows x 32 floats, one 128-byte
// swizzled row each (TMA's box, the wgmma descriptors' K-major layout).
constexpr int kF32Cols = 32;                 // floats of a box row
constexpr int kF32Box = kBQ * kF32Cols * 4;  // 8 KB
constexpr int kF32Stage = 2 * kF32Box;       // a q and a k chunk, or 64 columns of v
constexpr int kF32Split = kF32Stage / 16 / kConsumers;  // float4 of a chunk a consumer splits

template <int DV>
struct F32Tile {
  static constexpr int kVBoxes = DV / kF32Cols;  // boxes of v a key tile: 1 or 2
  static constexpr int kStages = DV == 32 ? 4 : 3;
  static constexpr int kVtBytes = DV * 2 * 128;  // v^T: DV rows of 64 keys, two 128-byte blocks
  // the stages, the low parts of a q and a k chunk, v^T's high and low
  // parts and the mbarriers (full[s], empty[s]), after 1024 bytes of room
  // to align the base: two blocks a multiprocessor
  static constexpr long long kSmem = 1024 + static_cast<long long>(kF32Stage) * (kStages + 1) +
                                     2LL * kVtBytes + 16 * kStages;
};

// x rounded to tf32, to nearest with ties away from zero (an add and a
// mask on the sign-magnitude pattern, as cvt.rna.tf32.f32 rounds, which is
// a longer sequence of integer operations on this card; no NaN or
// infinity reaches it): its low 13 bits zero, a value the tensor cores
// multiply exactly, whatever they do with bits below tf32's.
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo up to lo's rounding: hi = tf32(x), lo = tf32(x - hi) (x - hi
// is exact, with at most 13 significant bits, and its sign is x's or not
// with equal odds, so the roundings of lo do not drift one way along a
// sum; a truncation split would).  The product of two such sums without
// the lo.lo term keeps about 22 significant bits of each factor.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32(x);
  lo = tf32(x - hi);
}

// d (64 x 64 float32) = a . b^T, or += with accumulate; a (64 x 8) and b
// (64 x 8) tf32, K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32 float32) += a . b: a (64 x 8 tf32) in registers (of each
// warp's 16 rows, rows grp and grp + 8, columns tg and tg + 4), b (8 x 32)
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64 float32) += a . b, as above with b (8 x 64).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// The consumer warpgroup's own barrier (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The q and k chunks of a stage (two boxes as TMA landed them) into their
// tf32 high parts, in place, and their low parts, kept in registers for
// store_lo: element by element, so the swizzle carries over.
__device__ __forceinline__ void split_qk(uint8_t* stage, float4 (&lo)[kF32Split], int tid) {
  float4* s4 = reinterpret_cast<float4*>(stage);
#pragma unroll
  for (int i = 0; i < kF32Split; ++i) {
    const float4 x = s4[tid + i * kConsumers];
    float4 h;
    split_tf32(x.x, h.x, lo[i].x);
    split_tf32(x.y, h.y, lo[i].y);
    split_tf32(x.z, h.z, lo[i].z);
    split_tf32(x.w, h.w, lo[i].w);
    s4[tid + i * kConsumers] = h;
  }
}

// The low parts into the low-part buffer, at their offsets in the stage.
__device__ __forceinline__ void store_lo(uint8_t* buf, const float4 (&lo)[kF32Split], int tid) {
  float4* l4 = reinterpret_cast<float4*>(buf);
#pragma unroll
  for (int i = 0; i < kF32Split; ++i) l4[tid + i * kConsumers] = lo[i];
}

// A key tile of v (64 keys x DV columns in DV / 32 boxes of the 128-byte
// swizzle, as TMA landed them; the first `boxes` hold columns of d, the
// rest read as zeros) into v^T's tf32 high and low parts: DV rows (a column of v each) of 64 keys, K-major in two
// 128-byte-swizzled blocks of 32 keys, the keys of each 8 permuted as the
// p fragments hold them (key 8g + 2i + e at position 8g + i + 4e), so p.v
// needs no shuffle of p.  A warp takes 32 columns and 4 positions at a
// time: its reads (one key row of a box) and its 16-byte writes (8 rows a
// phase, in distinct swizzle chunks) are free of bank conflicts.
template <int DV>
__device__ __forceinline__ void split_v(const uint8_t* v_stage, uint8_t* vt_hi, uint8_t* vt_lo,
                                        int boxes, int warp, int lane) {
#pragma unroll 2
  for (int item = warp; item < F32Tile<DV>::kVBoxes * 16; item += kConsumers / 32) {
    const int cg = item >> 4, kc = item & 15;    // the box; positions 4kc..4kc + 3
    const int c = cg * kF32Cols + lane;          // v's column, v^T's row
    const int key0 = 8 * (kc >> 1) + (kc & 1);  // the keys key0 + 2i
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = key0 + 2 * i;
      x[i] = cg < boxes ? *reinterpret_cast<const float*>(
                              v_stage + cg * kF32Box + r * 128 +
                              ((((lane >> 2) ^ (r & 7)) << 4) | ((lane & 3) << 2)))
                        : 0.0f;
    }
    float4 h, l;
    split_tf32(x[0], h.x, l.x);
    split_tf32(x[1], h.y, l.y);
    split_tf32(x[2], h.z, l.z);
    split_tf32(x[3], h.w, l.w);
    const uint32_t at = (kc >> 3) * (DV * 128) + c * 128 + (((kc & 7) ^ (c & 7)) << 4);
    *reinterpret_cast<float4*>(vt_hi + at) = h;
    *reinterpret_cast<float4*>(vt_lo + at) = l;
  }
}

// One block: 64 query rows of one (batch row, head) and DV output columns
// of d (column blocks past DV on the grid's head axis); see the header.
// Two blocks an SM (shared memory; so at most 204 registers a thread).
template <int DV>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map, const float* __restrict__ v,
                      Strides vs, int sq, int sk, int rep, int causal, int window, int d,
                      int nb, float scale) {
  using T = F32Tile<DV>;
  constexpr int kS = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  uint8_t* const gbase = smem_raw + (base - raw);  // the same address, generic
  auto stage = [&](int s) { return base + kF32Stage * s; };
  const uint32_t lo = base + kF32Stage * kS;  // the low parts of the current q and k chunks
  const uint32_t vt_hi = lo + kF32Stage, vt_lo = vt_hi + T::kVtBytes;
  const uint32_t bars = vt_lo + T::kVtBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kS + s); };

  const int h = blockIdx.x / nb, col0 = (blockIdx.x % nb) * DV;
  const int b = blockIdx.y, iq = gridDim.z - 1 - blockIdx.z;
  const int g = h / rep, q0 = iq * kBQ;
  const int nkc = (d + kF32Cols - 1) / kF32Cols;  // q/k chunks of a key tile
  // the boxes of v's block columns that hold columns of d
  const int vboxes = min(T::kVBoxes, (d - col0 + kF32Cols - 1) / kF32Cols);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TileRange tr = tile_range(iq, sq, sk, causal, window);

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer: per key tile nkc (q, k) chunks, then v
    if (lane == 0) {
      int it = 0;
      for (int t = tr.t_begin; t < tr.t_end; ++t) {
        for (int c = 0; c <= nkc; ++c, ++it) {
          const int s = it % kS;
          if (it >= kS) mbar_wait(empty(s), (it / kS - 1) & 1);
          if (c < nkc) {
            mbar_expect_tx(full(s), 2 * kF32Box);
            tma_load(&q_map, stage(s), full(s), c * kF32Cols, h, q0, b);
            tma_load(&k_map, stage(s) + kF32Box, full(s), c * kF32Cols, g, t * kBK, b);
          } else {
            mbar_expect_tx(full(s), vboxes * kF32Box);
            for (int vb = 0; vb < vboxes; ++vb)
              tma_load(&v_map, stage(s) + vb * kF32Box, full(s), col0 + vb * kF32Cols, g,
                       t * kBK, b);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup; this thread's rows: row0 and row0 + 8
  const int grp = lane >> 2, tg = lane & 3;
  const int row0 = q0 + warp * 16 + grp;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  int it = 0;
  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    // scores over d, a 32-column chunk a stage: lo.hi, hi.lo, then hi.hi.
    // A chunk's split (loads, arithmetic, high parts in place) runs while
    // the last chunk's products do; only its low parts wait for them.
    float p[32];
    int last = 0;  // the stage of the chunk whose products are in flight
    for (int c = 0; c < nkc; ++c, ++it) {
      const int s = it % kS;
      mbar_wait(full(s), (it / kS) & 1);
      float4 lo_r[kF32Split];
      split_qk(gbase + kF32Stage * s, lo_r, tid);
      if (c > 0) {
        wgmma_wait();
        fence_regs(p);
        mbar_arrive(empty(last));
      }
      consumers_sync();  // every warp's products of the last chunk are done with lo
      store_lo(gbase + (lo - base), lo_r, tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      consumers_sync();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kF32Cols / 8; ++kk) {
        const uint64_t qh = desc(stage(s) + kk * 32, 16, 1024, 1);
        const uint64_t kh = desc(stage(s) + kF32Box + kk * 32, 16, 1024, 1);
        const uint64_t ql = desc(lo + kk * 32, 16, 1024, 1);
        const uint64_t kl = desc(lo + kF32Box + kk * 32, 16, 1024, 1);
        wgmma_tf32_ss(p, ql, kh, c > 0 || kk > 0);
        wgmma_tf32_ss(p, qh, kl, 1);
        wgmma_tf32_ss(p, qh, kh, 1);
      }
      wgmma_commit();
      last = s;
    }

    // v^T of this tile while the last chunk's products run (every warp's
    // p.v of the last tile is done: the chunk barriers came after it)
    {
      const int s = it % kS;
      mbar_wait(full(s), (it / kS) & 1);
      split_v<DV>(gbase + kF32Stage * s, gbase + (vt_hi - base), gbase + (vt_lo - base),
                  vboxes, warp, lane);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(empty(s));
      ++it;
    }
    wgmma_wait();
    fence_regs(p);
    mbar_arrive(empty(last));

    const int j0 = t * kBK;
    const bool edge = j0 + kBK > sk || (causal && j0 + kBK - 1 > q0) ||
                      (window != 0 && static_cast<long long>(j0) <=
                                          static_cast<long long>(q0) + kBQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!key_valid(j0 + 8 * j + 2 * tg + (e & 1), row0 + 8 * (e >> 1), sk, causal,
                         window))
            p[4 * j + e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], p[j]);
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // equal maxima (both -inf before any valid key) leave the sums as they are
      alpha[r] = m_new == m[r] ? 1.0f : ex2((m[r] - m_new) * scale);
      ms[r] = m_new == -INFINITY ? 0.0f : m_new * scale;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      p[j] = ex2(fmaf(p[j], scale, -ms[(j >> 1) & 1]));
      l[(j >> 1) & 1] += p[j];
    }
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

    // O += p.v, 8 keys a step: the a registers of step kk are p at keys
    // 8kk + 2tg (positions tg) and 8kk + 2tg + 1 (positions tg + 4) of
    // rows grp and grp + 8, in tf32 high and low parts
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float hi, low;
        split_tf32(p[4 * kk + ((f & 1) << 1) + (f >> 1)], hi, low);
        ph[kk][f] = __float_as_uint(hi);
        pl[kk][f] = __float_as_uint(low);
      }
    }
    consumers_sync();  // every warp's part of v^T is written
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * (DV * 128) + (kk & 3) * 32;
      const uint64_t vh = desc(vt_hi + off, 16, 1024, 1), vl = desc(vt_lo + off, 16, 1024, 1);
      wgmma_tf32_rs(o, pl[kk], vh);
      wgmma_tf32_rs(o, ph[kk], vl);
      wgmma_tf32_rs(o, ph[kk], vh);
    }
    wgmma_commit_and_wait();
    fence_regs(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // rows left with no valid key: 1/Sk times the sum of v over all keys,
  // this thread's columns of the block read from device memory
  const bool empty_row[2] = {row0 < sq && l[0] == 0.0f, row0 + 8 < sq && l[1] == 0.0f};
  if (empty_row[0] || empty_row[1]) {
    const float inv = 1.0f / static_cast<float>(sk);
    const float* vb = v + b * vs.b + g * vs.h + col0;
    float sum[DV / 4];
#pragma unroll
    for (int c = 0; c < DV / 4; ++c) sum[c] = 0.0f;
    for (int j = 0; j < sk; ++j) {
      const float* vr = vb + static_cast<long long>(j) * vs.s + 2 * tg;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        if (col0 + 8 * c < d) {  // d is a multiple of 8: the 8 columns are all in or all out
          sum[2 * c] += inv * vr[8 * c];
          sum[2 * c + 1] += inv * vr[8 * c + 1];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!empty_row[r]) continue;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        o[4 * c + 2 * r] = sum[2 * c];
        o[4 * c + 2 * r + 1] = sum[2 * c + 1];
      }
      l[r] = 1.0f;
    }
  }

  // o / l into stage 0 (every wgmma of the warpgroup has read the ring,
  // and the producer has no load left) in the boxes' swizzle, then a TMA
  // store per box that holds columns of d
  consumers_sync();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + grp + 8 * r;
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      const int col = 8 * c + 2 * tg;
      const uint32_t off = row * 128 + (col % kF32Cols) * 4;
      const uint32_t at = (col / kF32Cols) * kF32Box + (off ^ (((off >> 7) & 7) << 4));
      *reinterpret_cast<float2*>(gbase + at) =
          make_float2(o[4 * c + 2 * r] / l[r], o[4 * c + 2 * r + 1] / l[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync();
  if (tid == 0) {
    for (int vb = 0; vb < vboxes; ++vb)
      tma_store(&o_map, base + vb * kF32Box, col0 + vb * kF32Cols, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launchers
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through cudaGetDriverEntryPoint, so the
// library links against libcuda at no point (null if the lookup fails).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a (batch, seq, heads, d) operand at `ptr` (float32 if
// f32, else bf16) with element strides st = (batch, seq, head) and d
// contiguous, as the 4-d tensor (d, heads, seq, batch), in boxes of
// `box_cols` columns of 64 rows in the swizzle of their row's bytes (64 or
// 128); coordinates past d or past seq read as zeros (and a store there is
// dropped).  False if the encode fails.
bool encode(CUtensorMap* map, const void* ptr, bool f32, int d, long long batch, long long seq,
            long long heads, const long long* st, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(st[2]) * esize,
                               static_cast<cuuint64_t>(st[1]) * esize,
                               static_cast<cuuint64_t>(st[0]) * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, kBQ, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols * esize == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The four tensor maps (o contiguous) in boxes of box_cols columns.
bool encode_all(CUtensorMap* maps, const void* q, const void* k, const void* v, void* o,
                bool f32, int d, int batch, int sq, int sk, int heads, int kv_heads,
                const long long* st, int box_cols) {
  const long long ost[3] = {static_cast<long long>(sq) * heads * d,
                            static_cast<long long>(heads) * d, d};
  return encode(&maps[0], q, f32, d, batch, sq, heads, st, box_cols) &&
         encode(&maps[1], k, f32, d, batch, sk, kv_heads, st + 3, box_cols) &&
         encode(&maps[2], v, f32, d, batch, sk, kv_heads, st + 6, box_cols) &&
         encode(&maps[3], o, f32, d, batch, sq, heads, ost, box_cols);
}

// log2(e) / sqrt(d): the kernels' scale of the raw scores in exp2.
float exp2_scale(int d) {
  return static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(d)));
}

// The float32 launch at d <= DV, or past 64 in column blocks of DV = 64:
// the four tensor maps over the real d in boxes of 32 floats, then the
// kernel.
template <int DV>
int launch_f32(const plan::Plan& p, const void* q, const void* k, const void* v, void* o,
               int d, int batch, int sq, int sk, int heads, int kv_heads, int causal,
               int window, const long long* st, cudaStream_t stream) {
  if (p.block[0] != kWgThreads || p.smem < F32Tile<DV>::kSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!encode_all(m, q, k, v, o, true, d, batch, sq, sk, heads, kv_heads, st, kF32Cols))
    return static_cast<int>(cudaErrorInvalidValue);
  return plan::launch(flash_fwd_tf32_kernel<DV>, p, stream, m[0], m[1], m[2], m[3],
                      static_cast<const float*>(v), Strides{st[6], st[7], st[8]}, sq, sk,
                      heads / kv_heads, causal, window, d, (d + DV - 1) / DV, exp2_scale(d));
}

// The bf16 launch at d <= D: the four tensor maps over the real d, then
// the kernel.
template <int D>
int launch_bf16(const plan::Plan& p, const void* q, const void* k, const void* v, void* o,
                int d, int batch, int sq, int sk, int heads, int kv_heads, int causal,
                int window, const long long* st, cudaStream_t stream) {
  if (p.block[0] != kWgThreads || p.smem < Tile<D>::kSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!encode_all(m, q, k, v, o, false, d, batch, sq, sk, heads, kv_heads, st,
                  Tile<D>::kW))
    return static_cast<int>(cudaErrorInvalidValue);
  return plan::launch(flash_fwd_wgmma_kernel<D>, p, stream, m[0], m[1], m[2], m[3],
                      static_cast<const __nv_bfloat16*>(v), Strides{st[6], st[7], st[8]}, sq,
                      sk, heads / kv_heads, causal, window, d, exp2_scale(d));
}

// The bf16 launch past the largest Tile: column blocks of 128.
int launch_bf16_cols(const plan::Plan& p, const void* q, const void* k, const void* v, void* o,
                     int d, int batch, int sq, int sk, int heads, int kv_heads, int causal,
                     int window, const long long* st, cudaStream_t stream) {
  if (p.block[0] != kWgThreads || p.smem < kColSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!encode_all(m, q, k, v, o, false, d, batch, sq, sk, heads, kv_heads, st,
                  kChunkCols))
    return static_cast<int>(cudaErrorInvalidValue);
  return plan::launch(flash_fwd_wgmma_cols_kernel<128>, p, stream, m[0], m[1], m[2], m[3],
                      static_cast<const __nv_bfloat16*>(v), Strides{st[6], st[7], st[8]}, sq,
                      sk, heads / kv_heads, causal, window, d, (d + 127) / 128, exp2_scale(d));
}

using Launch = int (*)(const plan::Plan&, const void*, const void*, const void*, void*, int,
                       int, int, int, int, int, int, int, const long long*, cudaStream_t);

// The kernel of head dim d (a positive multiple of 8): bf16, the
// instantiation D of 32, 64, 128 next at or above d, its tiles zero past d,
// and past 128 the column-block kernel; float32, DV = 32 up to d = 32,
// else DV = 64 (column blocks of 64 past 64).
Launch pick(int dtype, int d) {
  if (d < 8 || d % 8 != 0) return nullptr;
  if (dtype == 0) return d <= 32 ? &launch_f32<32> : &launch_f32<64>;
  if (d <= 32) return &launch_bf16<32>;
  if (d <= 64) return &launch_bf16<64>;
  if (d <= 128) return &launch_bf16<128>;
  return &launch_bf16_cols;
}

const plan::Kernel kKernels[] = {
    {"flash_fwd_tf32_kernel<32>", reinterpret_cast<const void*>(&flash_fwd_tf32_kernel<32>)},
    {"flash_fwd_tf32_kernel<64>", reinterpret_cast<const void*>(&flash_fwd_tf32_kernel<64>)},
    {"flash_fwd_wgmma_kernel<32>", reinterpret_cast<const void*>(&flash_fwd_wgmma_kernel<32>)},
    {"flash_fwd_wgmma_kernel<64>", reinterpret_cast<const void*>(&flash_fwd_wgmma_kernel<64>)},
    {"flash_fwd_wgmma_kernel<128>",
     reinterpret_cast<const void*>(&flash_fwd_wgmma_kernel<128>)},
    {"flash_fwd_wgmma_cols_kernel<128>",
     reinterpret_cast<const void*>(&flash_fwd_wgmma_cols_kernel<128>)}};

}  // namespace

PLAN_KERNEL_TABLE(flash_attn, kKernels)

// q: (batch, sq, heads, d), k and v: (batch, sk, kv_heads, d), each with
// element strides st[0..2] (q), st[3..5] (k), st[6..8] (v) over its batch,
// sequence and head axes and d contiguous; o: contiguous (batch, sq, heads,
// d) of the same type.  dtype 0 is float32, 1 bfloat16; every pointer
// 16-byte aligned and every stride a multiple of 16 bytes (TMA's rule); d
// is a positive multiple of 8 (pick); heads a multiple of kv_heads; sk >=
// 1.  The plan (attn_kernel.launch_plan): 160 threads a block; float32,
// grid (heads x column blocks of DV, batch, query tiles) with
// F32Tile<DV>::kSmem bytes; bfloat16, grid (heads, batch, query tiles) with
// Tile<D>::kSmem bytes, or past d = 128 grid (heads x column blocks, batch,
// query tiles) with kColSmem bytes; opted in above 48 KB.  Refuses another block, too little
// shared memory, or a tensor map that cuTensorMapEncodeTiled refuses
// (cudaErrorInvalidValue).  Returns cudaGetLastError() after the launch (0
// on success); a grid past the card's limits is refused there.
extern "C" int flash_attn_launch(const plan::Plan* p, const void* q, const void* k,
                                 const void* v, void* o, int dtype, int d, int batch,
                                 int sq, int sk, int heads, int kv_heads, int causal,
                                 int window, const long long* st, void* stream) {
  if (batch == 0 || sq == 0 || heads == 0) return 0;
  const Launch fn = dtype == 0 || dtype == 1 ? pick(dtype, d) : nullptr;
  if (fn == nullptr || sk < 1 || kv_heads < 1 || heads % kv_heads != 0 || p->block[1] != 1 ||
      p->block[2] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(*p, q, k, v, o, d, batch, sq, sk, heads, kv_heads, causal, window, st,
            static_cast<cudaStream_t>(stream));
}
