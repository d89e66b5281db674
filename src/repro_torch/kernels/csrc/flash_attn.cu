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
// The bound of the function on the card: bytes.  At whisper-large-v3's
// decoder shape (4, 384, 20, 64) bf16, causal, it reads q, k and v once
// and writes o once, 15.7 MB: 4.7 us at 3.35 TB/s.  Its products are 1.5
// GFLOP of causal q.k and p.v; with p.v taken as three bf16 products
// (below) the tensor cores do about 3.0 GFLOP, 3.1 us at the 989 TFLOP/s
// bf16 peak, so the bound stays the bytes.
//
// Both kernels take a block per (query tile of 64 rows, head, batch row),
// visit only the 64-key tiles that can hold a valid key for one of the
// block's rows (tile_range), keep the running max, sum and output in
// registers, and read q, k and v in place in the (B, S, H, d) layout from
// their element strides (d contiguous), with no transposed copy.  The
// masked scores are -inf and their probabilities exactly 0, so a tile with
// no valid key for a row adds nothing (the Pallas kernel lets such a tile
// add exp(0) terms until a real tile rescales them away).
//
// Head dims: every positive multiple of 8, which is what the reference's
// routing admits (src/repro/models/common.py:185-188) and its Pallas
// kernel runs ((1, 1, block, d) BlockSpecs).  Both kernels are
// instantiated at D = 32, 64 and 128, and D serves every d in (the
// previous D, D] on tiles zero past d: the bf16 kernel's tensor maps span
// the real d, so TMA's out-of-bounds fill gives zero columns of q, k and v
// and its store clips o's columns past d; the float32 kernel masks its
// column loads and stores.  Zero columns change neither q.k nor o's first
// d columns, and the scale is 1/sqrt(d) of the real d, passed at run time.
// Past d = 128 a block owns 128 output columns (column blocks on the
// grid): it takes q.k over the whole d in chunks and then p.v over its
// 128 columns of v, so d has no upper limit, at the cost of the scores
// once a column block.  The float32 kernel<128> stages 128-column chunks
// of q and k in turn; the bf16 flash_fwd_wgmma_cols_kernel streams
// 64-column chunks of q and k through its TMA ring.  Not a D = 256 bf16
// instantiation: its accumulator alone would be 128 registers a thread
// beside the scores and the split of p (the D = 128 kernel already takes
// 165), past the 255 a thread has without spilling, and its q tile and two
// stages of k and v would fill 160 KB, one block a multiprocessor.
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
// float32, flash_fwd_kernel, on the FMA pipes (67 TFLOP/s; no model path
// runs it): 128 threads, two per query row, each holding the row of q in
// registers (at d = 128 in shared memory: registers would spill), scoring
// 32 of a tile's 64 keys (the interleaved keys 2i + half) and accumulating
// half of the output columns; k and v staged by all threads into shared
// memory, k's tile rows padded to d + 4 floats and v's columns owned in
// alternating float4 chunks so the two halves' reads fall in other banks.
//
// Built without -fmad=false (see runtime.py): the scores and the output
// are sums of d and Sk products with no bit-for-bit contract with the
// reference, and a fused multiply-add rounds once where a multiply and an
// add round twice.  Division and sqrt are the IEEE versions (no fast
// math); exp2 is the hardware's ex2.approx (2 ulp) on the bf16 path.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "plan.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kThreads = 128;   // the float32 kernel: 2 threads per row
constexpr int kKeys = kBK / 2;  // keys of a tile per thread (float32)
constexpr int kConsumers = 128;              // bf16: one warpgroup, 64 rows
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
// float32: FMA pipes
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int sk, int heads, int rep, int causal, int window,
                 Strides qs, Strides ks, Strides vs, int d, int nb) {
  constexpr int kLd = D + 4;      // k tile row stride, floats
  constexpr int kCols = D / 2;    // output columns per thread
  constexpr int kChunks = D / 8;  // float4 chunks per thread
  extern __shared__ float4 smem4[];
  float* k_tile = reinterpret_cast<float*>(smem4);  // kBK x kLd
  float* v_tile = k_tile + kBK * kLd;               // kBK x D

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y / nb, col0 = (blockIdx.y % nb) * D;  // the block's output columns
  const int b = blockIdx.z, g = h / rep;
  const int tid = threadIdx.x, half = tid & 1;
  const int qi = iq * kBQ + (tid >> 1);
  const bool active = qi < sq;
  const float sqrt_d = sqrtf(static_cast<float>(d));
  // q.k runs over d in chunks of D columns: one for every d <= D; more
  // only in the D = 128 kernel, past the largest instantiation
  const int nch = (d + D - 1) / D;

  const float* kb = k + b * ks.b + g * ks.h;
  const float* vb = v + b * vs.b + g * vs.h;

  // the row of q (a row past Sq reads the last row, never written back),
  // zero past d: in registers for D <= 64; at D = 128 those 128 registers
  // with the accumulator and the scores spill (255 registers and 160
  // bytes of local memory), so the row is staged in shared memory after
  // the v tile, rows padded to kLd floats, each half of the pair writing
  // every other value (the first tile's barrier publishes them), and the
  // scores loop over d outside the keys.  With several chunks the row's
  // chunk is staged with each chunk of k.
  constexpr bool kQShared = D > 64;
  float qr[kQShared ? 1 : D];
  float* q_row = v_tile + kBK * D + (tid >> 1) * kLd;
  const float* qp = q + b * qs.b + static_cast<long long>(min(qi, sq - 1)) * qs.s + h * qs.h;
  if constexpr (kQShared) {
    if (nch == 1) {
      for (int c = half; c < D; c += 2) q_row[c] = c < d ? qp[c] : 0.0f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = c < d ? qp[c] : 0.0f;
  }

  const TileRange tr = tile_range(iq, sq, sk, causal, window);
  float m = -INFINITY, l = 0.0f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;

  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int j0 = t * kBK;
    // raw scores q . k of this thread's keys j0 + 2i + half, summed over
    // d in order (the zero columns past d add exact zeros)
    float s[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) s[i] = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      const int cc = ch * D;  // the chunk's first column
      __syncthreads();        // the previous tile (or chunk) is consumed
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int jr = e / D, c = e % D, j = j0 + jr;
        const bool in = j < sk;
        k_tile[jr * kLd + c] =
            in && cc + c < d ? kb[static_cast<long long>(j) * ks.s + cc + c] : 0.0f;
        if (ch == 0) {
          v_tile[jr * D + c] =
              in && col0 + c < d ? vb[static_cast<long long>(j) * vs.s + col0 + c] : 0.0f;
        }
      }
      if constexpr (kQShared) {
        if (nch > 1) {
          for (int c = half; c < D; c += 2) q_row[c] = cc + c < d ? qp[cc + c] : 0.0f;
        }
      }
      __syncthreads();

      if constexpr (kQShared) {
        // d outer, keys inner: each value of q is read once for all the
        // keys, so no row of q is live in registers; each key's dot still
        // adds its d products in order, as below
        const float4* qv = reinterpret_cast<const float4*>(q_row);
#pragma unroll 2
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 qq = qv[c4];
#pragma unroll
          for (int i = 0; i < kKeys; ++i) {
            const float4 kk = reinterpret_cast<const float4*>(k_tile + (2 * i + half) * kLd)[c4];
            s[i] += qq.x * kk.x;
            s[i] += qq.y * kk.y;
            s[i] += qq.z * kk.z;
            s[i] += qq.w * kk.w;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          const float4* kr = reinterpret_cast<const float4*>(k_tile + (2 * i + half) * kLd);
          float dot = 0.0f;
#pragma unroll
          for (int c4 = 0; c4 < D / 4; ++c4) {
            const float4 kk = kr[c4];
            dot += qr[4 * c4] * kk.x;
            dot += qr[4 * c4 + 1] * kk.y;
            dot += qr[4 * c4 + 2] * kk.z;
            dot += qr[4 * c4 + 3] * kk.w;
          }
          s[i] = dot;
        }
      }
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      s[i] = key_valid(j0 + 2 * i + half, qi, sk, causal, window) ? s[i] / sqrt_d : -INFINITY;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    // equal maxima (both -inf before any valid key) leave the sums as they are
    const float alpha = m_new == m ? 1.0f : expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      s[i] = s[i] == -INFINITY ? 0.0f : expf(s[i] - m_new);
      psum += s[i];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;

    // acc += p . v over the tile: keys 2i (even) and 2i + 1 (odd); this
    // thread owns the float4 column chunks 2c + half
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const float other = __shfl_xor_sync(0xffffffffu, s[i], 1);
      const float p_even = half ? other : s[i];
      const float p_odd = half ? s[i] : other;
      const float4* v0 = reinterpret_cast<const float4*>(v_tile + (2 * i) * D);
      const float4* v1 = reinterpret_cast<const float4*>(v_tile + (2 * i + 1) * D);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 a = v0[2 * c + half], z = v1[2 * c + half];
        acc[4 * c] += p_even * a.x;
        acc[4 * c] += p_odd * z.x;
        acc[4 * c + 1] += p_even * a.y;
        acc[4 * c + 1] += p_odd * z.y;
        acc[4 * c + 2] += p_even * a.z;
        acc[4 * c + 2] += p_odd * z.z;
        acc[4 * c + 3] += p_even * a.w;
        acc[4 * c + 3] += p_odd * z.w;
      }
    }
  }

  // rows left with no valid key: 1/Sk times the sum of v over all keys
  const bool empty = active && l == 0.0f;
  if (__syncthreads_or(empty)) {
    const float inv = 1.0f / static_cast<float>(sk);
    float sum[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) sum[c] = 0.0f;
    for (int j0 = 0; j0 < sk; j0 += kBK) {
      __syncthreads();
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int jr = e / D, c = e % D, j = j0 + jr;
        v_tile[jr * D + c] =
            j < sk && col0 + c < d ? vb[static_cast<long long>(j) * vs.s + col0 + c] : 0.0f;
      }
      __syncthreads();
      const int n = min(kBK, sk - j0);
      for (int jr = 0; jr < n; ++jr) {
        const float4* vr = reinterpret_cast<const float4*>(v_tile + jr * D);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 a = vr[2 * c + half];
          sum[4 * c] += inv * a.x;
          sum[4 * c + 1] += inv * a.y;
          sum[4 * c + 2] += inv * a.z;
          sum[4 * c + 3] += inv * a.w;
        }
      }
    }
    if (empty) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = sum[c];
      l = 1.0f;
    }
  }

  if (active) {
    float* op = o + (static_cast<long long>(b) * sq + qi) * heads * d
                + static_cast<long long>(h) * d + col0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (2 * c + half) * 4 + e;
        if (col0 + col < d) op[col] = acc[4 * c + e] / l;
      }
    }
  }
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

// The float32 kernel's dynamic shared memory: the k tile (kBK rows of
// D + 4 floats), the v tile (kBK rows of D) and, for D > 64, the block's
// q rows (kBQ rows of D + 4).  The launcher refuses a plan with less
// (attn_kernel.launch_plan computes it).
template <int D>
constexpr long long f32_smem() {
  return static_cast<long long>(sizeof(float)) *
         (kBK * (2 * D + 4) + (D > 64 ? kBQ * (D + 4) : 0));
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

// The tensor map of a (batch, seq, heads, d) bf16 operand at `ptr` with
// element strides st = (batch, seq, head) and d contiguous, as the 4-d
// tensor (d, heads, seq, batch), in boxes of `box_cols` columns of 64 rows
// in the swizzle of box_cols * 2-byte rows; coordinates past d or past seq
// read as zeros (and a store there is dropped).  False if the encode
// fails.
bool encode(CUtensorMap* map, const void* ptr, int d, long long batch, long long seq,
            long long heads, const long long* st, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                               static_cast<cuuint64_t>(st[1]) * 2,
                               static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, kBQ, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The four tensor maps (o contiguous) in boxes of box_cols columns.
bool encode_all(CUtensorMap* maps, const void* q, const void* k, const void* v, void* o, int d,
                int batch, int sq, int sk, int heads, int kv_heads, const long long* st,
                int box_cols) {
  const long long ost[3] = {static_cast<long long>(sq) * heads * d,
                            static_cast<long long>(heads) * d, d};
  return encode(&maps[0], q, d, batch, sq, heads, st, box_cols) &&
         encode(&maps[1], k, d, batch, sk, kv_heads, st + 3, box_cols) &&
         encode(&maps[2], v, d, batch, sk, kv_heads, st + 6, box_cols) &&
         encode(&maps[3], o, d, batch, sq, heads, ost, box_cols);
}

// log2(e) / sqrt(d): the bf16 kernels' scale of the raw scores in exp2.
float exp2_scale(int d) {
  return static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(d)));
}

// Column blocks of the float32 kernel: more than one only past D = 128.
int f32_col_blocks(int d) { return d > 128 ? (d + 127) / 128 : 1; }

template <int D>
int launch_f32(const plan::Plan& p, const void* q, const void* k, const void* v, void* o,
               int d, int batch, int sq, int sk, int heads, int kv_heads, int causal,
               int window, const long long* st, cudaStream_t stream) {
  (void)batch;
  if (p.block[0] != kThreads || p.smem < f32_smem<D>())
    return static_cast<int>(cudaErrorInvalidValue);
  return plan::launch(flash_fwd_kernel<D>, p, stream, static_cast<const float*>(q),
                      static_cast<const float*>(k), static_cast<const float*>(v),
                      static_cast<float*>(o), sq, sk, heads, heads / kv_heads, causal,
                      window, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                      Strides{st[6], st[7], st[8]}, d, f32_col_blocks(d));
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
  if (!encode_all(m, q, k, v, o, d, batch, sq, sk, heads, kv_heads, st, Tile<D>::kW))
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
  if (!encode_all(m, q, k, v, o, d, batch, sq, sk, heads, kv_heads, st, kChunkCols))
    return static_cast<int>(cudaErrorInvalidValue);
  return plan::launch(flash_fwd_wgmma_cols_kernel<128>, p, stream, m[0], m[1], m[2], m[3],
                      static_cast<const __nv_bfloat16*>(v), Strides{st[6], st[7], st[8]}, sq,
                      sk, heads / kv_heads, causal, window, d, (d + 127) / 128, exp2_scale(d));
}

using Launch = int (*)(const plan::Plan&, const void*, const void*, const void*, void*, int,
                       int, int, int, int, int, int, int, const long long*, cudaStream_t);

// The kernel of head dim d (a positive multiple of 8): the instantiation D
// of 32, 64, 128 next at or above d, its tiles zero past d; past 128 the
// float32 kernel's D = 128 in column blocks and the bf16 column-block
// kernel.
Launch pick(int dtype, int d) {
  if (d < 8 || d % 8 != 0) return nullptr;
  const bool f32 = dtype == 0;
  if (d <= 32) return f32 ? &launch_f32<32> : &launch_bf16<32>;
  if (d <= 64) return f32 ? &launch_f32<64> : &launch_bf16<64>;
  if (d <= 128) return f32 ? &launch_f32<128> : &launch_bf16<128>;
  return f32 ? &launch_f32<128> : &launch_bf16_cols;
}

const plan::Kernel kKernels[] = {
    {"flash_fwd_kernel<32>", reinterpret_cast<const void*>(&flash_fwd_kernel<32>)},
    {"flash_fwd_kernel<64>", reinterpret_cast<const void*>(&flash_fwd_kernel<64>)},
    {"flash_fwd_kernel<128>", reinterpret_cast<const void*>(&flash_fwd_kernel<128>)},
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
// d) of the same type.  dtype 0 is float32, 1 bfloat16 (then every pointer
// 16-byte aligned and every stride a multiple of 8 elements: TMA's rule); d
// is a positive multiple of 8 (pick); heads a multiple of kv_heads; sk >=
// 1.  The plan (attn_kernel.launch_plan): float32, 128 threads a block and
// grid (query tiles, heads x column blocks, batch) with the k and v tiles
// (at D = 128 also the q rows) in dynamic shared memory; bfloat16, 160
// threads and grid (heads, batch, query tiles) with Tile<D>::kSmem bytes,
// or past d = 128 grid (heads x column blocks, batch, query tiles) with
// kColSmem bytes; opted in above 48 KB.  Refuses another block, too little
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
