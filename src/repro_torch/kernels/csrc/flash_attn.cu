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
// What bounds it on the card: bytes.  At whisper-large-v3's decoder shape
// (4, 384, 20, 64) bf16, causal, the function reads q, k and v once and
// writes o once, 15.7 MB: 4.7 us at 3.35 TB/s, against 1.5 GFLOP of causal
// products, 1.5 us at the bf16 tensor-core peak.  Neither kernel here
// reaches that: they are simple first versions, with no asynchronous
// copies and no pipelining.
//
// Two kernels share the tiling: a block per (query tile of 64 rows, head,
// batch), the grid walking the query tiles from the last so the long
// causal rows start first; a loop over 64-key tiles of k and v staged in
// shared memory, with the running max, sum and output accumulator in
// registers; q, k and v read in place in the (B, S, H, d) layout from their
// element strides (d contiguous), with no transposed copy, rows past Sk
// staged as zeros and masked; tiles wholly above the causal diagonal or
// wholly before the window of the block's rows not visited.
//
//   - bfloat16 (the model path): flash_fwd_mma_kernel, four warps of 16
//     query rows each on the tensor cores (mma.sync m16n8k16, bf16 in,
//     float32 accumulate).  q.k: the bf16 products are exact and summed in
//     float32.  p.v: each float32 probability is split exactly into three
//     bf16 pieces (8 significant bits each, 24 in all) and the three
//     products are accumulated in float32, so the arithmetic stays float32
//     to rounding.  The scores' accumulator layout is the next product's
//     operand layout, so p never leaves registers; a row's max and sum
//     cross the four lanes that hold it by xor-shuffles.
//   - float32: flash_fwd_kernel, on the FMA pipes (67 TFLOP/s): two
//     threads per query row, each holding the row of q in registers (at
//     d = 128 in shared memory: registers would spill),
//     scoring 32 of a tile's 64 keys (the interleaved keys 2i + half) and
//     accumulating half of the output columns; k's tile rows are padded to
//     d + 4 floats and v's columns owned in alternating float4 chunks so
//     the two halves' reads fall in other banks.
// The masked scores are -inf and their probabilities exactly 0, so a tile
// with no valid key for a row adds nothing (the Pallas kernel lets such a
// tile add exp(0) terms until a real tile rescales them away).
//
// Built without -fmad=false (see runtime.py): the scores and the output
// are sums of d and Sk products with no bit-for-bit contract with the
// reference, and a fused multiply-add rounds once where a multiply and an
// add round twice.  Division and sqrt are the IEEE versions (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "plan.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kThreads = 128;   // 2 threads per row (FMA), 4 warps (mma)
constexpr int kKeys = kBK / 2;  // keys of a tile per thread (FMA)

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
                 Strides qs, Strides ks, Strides vs) {
  constexpr int kLd = D + 4;      // k tile row stride, floats
  constexpr int kCols = D / 2;    // output columns per thread
  constexpr int kChunks = D / 8;  // float4 chunks per thread
  extern __shared__ float4 smem4[];
  float* k_tile = reinterpret_cast<float*>(smem4);  // kBK x kLd
  float* v_tile = k_tile + kBK * kLd;               // kBK x D

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int tid = threadIdx.x, half = tid & 1;
  const int qi = iq * kBQ + (tid >> 1);
  const bool active = qi < sq;
  const float sqrt_d = sqrtf(static_cast<float>(D));

  const float* kb = k + b * ks.b + g * ks.h;
  const float* vb = v + b * vs.b + g * vs.h;

  // the row of q (a row past Sq reads the last row, never written back):
  // in registers for D <= 64; at D = 128 those 128 registers with the
  // accumulator and the scores spill (255 registers and 160 bytes of
  // local memory), so the row is staged in shared memory after the v tile,
  // rows padded to kLd floats, each half of the pair writing every other
  // value (the first tile's barrier publishes them), and the scores loop
  // over d outside the keys
  constexpr bool kQShared = D > 64;
  float qr[kQShared ? 1 : D];
  float* q_row = v_tile + kBK * D + (tid >> 1) * kLd;
  {
    const float* qp = q + b * qs.b + static_cast<long long>(min(qi, sq - 1)) * qs.s
                      + h * qs.h;
    if constexpr (kQShared) {
      for (int c = half; c < D; c += 2) q_row[c] = qp[c];
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) qr[c] = qp[c];
    }
  }

  const TileRange tr = tile_range(iq, sq, sk, causal, window);
  float m = -INFINITY, l = 0.0f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;

  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int j0 = t * kBK;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int jr = e / D, c = e % D, j = j0 + jr;
      const bool in = j < sk;
      k_tile[jr * kLd + c] = in ? kb[static_cast<long long>(j) * ks.s + c] : 0.0f;
      v_tile[jr * D + c] = in ? vb[static_cast<long long>(j) * vs.s + c] : 0.0f;
    }
    __syncthreads();

    // scores of this thread's keys j0 + 2i + half
    float s[kKeys];
    float tmax = -INFINITY;
    if constexpr (kQShared) {
      // d outer, keys inner: each value of q is read once for all the keys,
      // so no row of q is live in registers; each key's dot still adds its
      // d products in order, as below
#pragma unroll
      for (int i = 0; i < kKeys; ++i) s[i] = 0.0f;
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
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        s[i] = key_valid(j0 + 2 * i + half, qi, sk, causal, window) ? s[i] / sqrt_d
                                                                     : -INFINITY;
        tmax = fmaxf(tmax, s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const int jr = 2 * i + half;
        const float4* kr = reinterpret_cast<const float4*>(k_tile + jr * kLd);
        float dot = 0.0f;
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 kk = kr[c4];
          dot += qr[4 * c4] * kk.x;
          dot += qr[4 * c4 + 1] * kk.y;
          dot += qr[4 * c4 + 2] * kk.z;
          dot += qr[4 * c4 + 3] * kk.w;
        }
        s[i] = key_valid(j0 + jr, qi, sk, causal, window) ? dot / sqrt_d : -INFINITY;
        tmax = fmaxf(tmax, s[i]);
      }
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
        v_tile[jr * D + c] = j < sk ? vb[static_cast<long long>(j) * vs.s + c] : 0.0f;
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
    float* op = o + (static_cast<long long>(b) * sq + qi) * heads * D
                + static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) op[(2 * c + half) * 4 + e] = acc[4 * c + e] / l;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// c += a . b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 float32.  For
// lane = 4 * grp + tg: a = {(grp, 2tg..+1), (grp + 8, 2tg..+1), (grp,
// 2tg + 8..+9), (grp + 8, 2tg + 8..+9)}, b = {(k 2tg..+1, n grp), (k 2tg +
// 8..+9, n grp)}, c = {(grp, 2tg), (grp, 2tg + 1), (grp + 8, 2tg), (grp +
// 8, 2tg + 1)}; the lower column or k index in the lower 16 bits.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two float32 values as three bf16 pairs with x = hi + mid + lo exactly to
// float32 rounding: each residual is exact in float32 and keeps the next 8
// significant bits.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 z = __floats2bfloat162_rn(r0 - __low2float(m),
                                                 r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&z);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int sq, int sk, int heads,
                     int rep, int causal, int window, Strides qs, Strides ks,
                     Strides vs) {
  constexpr int kLd = D + 8;     // tile row stride, bf16: conflict-free reads
  constexpr int kNT = kBK / 8;   // 8-key column tiles of the scores
  constexpr int kKS = D / 16;    // 16-wide steps over d for q.k
  constexpr int kOT = D / 8;     // 8-column tiles of the output
  constexpr int kW = D / 2;      // 32-bit words of a row
  __shared__ __align__(16) uint16_t k_raw[kBK * kLd];
  __shared__ __align__(16) uint16_t v_raw[kBK * kLd];
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(k_raw);
  __nv_bfloat16* v_tile = reinterpret_cast<__nv_bfloat16*>(v_raw);
  const uint16_t* v16 = v_raw;

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int tid = threadIdx.x, lane = tid & 31, grp = lane >> 2, tg = lane & 3;
  // this thread's rows: grp and grp + 8 of its warp's 16
  const int row[2] = {iq * kBQ + (tid >> 5) * 16 + grp,
                      iq * kBQ + (tid >> 5) * 16 + grp + 8};
  const float sqrt_d = sqrtf(static_cast<float>(D));

  const __nv_bfloat16* kb = k + b * ks.b + g * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;

  // q as the a operand of q.k, in registers (rows past Sq read the last row)
  uint32_t qa[kKS][4];
  {
    const __nv_bfloat16* q0 = q + b * qs.b + h * qs.h
                              + static_cast<long long>(min(row[0], sq - 1)) * qs.s;
    const __nv_bfloat16* q1 = q + b * qs.b + h * qs.h
                              + static_cast<long long>(min(row[1], sq - 1)) * qs.s;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      qa[kk][0] = ld32(q0 + kk * 16 + 2 * tg);
      qa[kk][1] = ld32(q1 + kk * 16 + 2 * tg);
      qa[kk][2] = ld32(q0 + kk * 16 + 8 + 2 * tg);
      qa[kk][3] = ld32(q1 + kk * 16 + 8 + 2 * tg);
    }
  }

  const TileRange tr = tile_range(iq, sq, sk, causal, window);
  // running max and this thread's share of the row sum, rows grp, grp + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[kOT][4];
#pragma unroll
  for (int ot = 0; ot < kOT; ++ot) acc[ot][0] = acc[ot][1] = acc[ot][2] = acc[ot][3] = 0.0f;

  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int j0 = t * kBK;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * kW; e += kThreads) {
      const int jr = e / kW, w = e % kW, j = j0 + jr;
      const bool in = j < sk;
      *reinterpret_cast<uint32_t*>(k_tile + jr * kLd + 2 * w) =
          in ? ld32(kb + static_cast<long long>(j) * ks.s + 2 * w) : 0u;
      *reinterpret_cast<uint32_t*>(v_tile + jr * kLd + 2 * w) =
          in ? ld32(vb + static_cast<long long>(j) * vs.s + 2 * w) : 0u;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* kr = k_tile + (nt * 8 + grp) * kLd + 2 * tg;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        mma_bf16(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * tg + (e & 1);
        s[nt][e] = key_valid(j, row[e >> 1], sk, causal, window)
                       ? s[nt][e] / sqrt_d : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      // equal maxima (both -inf before any valid key) leave the sums as they are
      alpha[r] = m_new == m[r] ? 1.0f : expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] == -INFINITY ? 0.0f : expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int ot = 0; ot < kOT; ++ot) {
      acc[ot][0] *= alpha[0];
      acc[ot][1] *= alpha[0];
      acc[ot][2] *= alpha[1];
      acc[ot][3] *= alpha[1];
    }

    // acc += p . v, 16 keys a step; the scores' c layout is p's a layout
#pragma unroll
    for (int ks16 = 0; ks16 < kBK / 16; ++ks16) {
      uint32_t hi[4], mid[4], lo[4];
      split3(s[2 * ks16][0], s[2 * ks16][1], hi[0], mid[0], lo[0]);
      split3(s[2 * ks16][2], s[2 * ks16][3], hi[1], mid[1], lo[1]);
      split3(s[2 * ks16 + 1][0], s[2 * ks16 + 1][1], hi[2], mid[2], lo[2]);
      split3(s[2 * ks16 + 1][2], s[2 * ks16 + 1][3], hi[3], mid[3], lo[3]);
      const int k0 = ks16 * 16 + 2 * tg;
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot) {
        const int c = ot * 8 + grp;
        const uint32_t b0 = v16[k0 * kLd + c] | (uint32_t(v16[(k0 + 1) * kLd + c]) << 16);
        const uint32_t b1 = v16[(k0 + 8) * kLd + c] | (uint32_t(v16[(k0 + 9) * kLd + c]) << 16);
        mma_bf16(acc[ot], lo, b0, b1);
        mma_bf16(acc[ot], mid, b0, b1);
        mma_bf16(acc[ot], hi, b0, b1);
      }
    }
  }

  // the row sums over the four lanes of each row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // rows left with no valid key: 1/Sk times the sum of v over all keys
  const bool empty[2] = {row[0] < sq && l[0] == 0.0f, row[1] < sq && l[1] == 0.0f};
  if (__syncthreads_or(empty[0] || empty[1])) {
    const float inv = 1.0f / static_cast<float>(sk);
    float sum[kOT][2];
#pragma unroll
    for (int ot = 0; ot < kOT; ++ot) sum[ot][0] = sum[ot][1] = 0.0f;
    for (int j0 = 0; j0 < sk; j0 += kBK) {
      __syncthreads();
      for (int e = tid; e < kBK * kW; e += kThreads) {
        const int jr = e / kW, w = e % kW, j = j0 + jr;
        *reinterpret_cast<uint32_t*>(v_tile + jr * kLd + 2 * w) =
            j < sk ? ld32(vb + static_cast<long long>(j) * vs.s + 2 * w) : 0u;
      }
      __syncthreads();
      const int n = min(kBK, sk - j0);
      for (int jr = 0; jr < n; ++jr) {
#pragma unroll
        for (int ot = 0; ot < kOT; ++ot) {
          const int c = ot * 8 + 2 * tg;
          sum[ot][0] += inv * __bfloat162float(v_tile[jr * kLd + c]);
          sum[ot][1] += inv * __bfloat162float(v_tile[jr * kLd + c + 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!empty[r]) continue;
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot) {
        acc[ot][2 * r] = sum[ot][0];
        acc[ot][2 * r + 1] = sum[ot][1];
      }
      l[r] = 1.0f;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    __nv_bfloat16* op = o + (static_cast<long long>(b) * sq + row[r]) * heads * D
                        + static_cast<long long>(h) * D + 2 * tg;
#pragma unroll
    for (int ot = 0; ot < kOT; ++ot) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[ot][2 * r] / l[r],
                                                        acc[ot][2 * r + 1] / l[r]);
      *reinterpret_cast<__nv_bfloat162*>(op + ot * 8) = pair;
    }
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

template <int D>
int launch_f32(const plan::Plan& p, const void* q, const void* k, const void* v, void* o,
               int sq, int sk, int heads, int kv_heads, int causal, int window,
               const long long* st, cudaStream_t stream) {
  if (p.smem < f32_smem<D>()) return static_cast<int>(cudaErrorInvalidValue);
  return plan::launch(flash_fwd_kernel<D>, p, stream, static_cast<const float*>(q),
                      static_cast<const float*>(k), static_cast<const float*>(v),
                      static_cast<float*>(o), sq, sk, heads, heads / kv_heads, causal,
                      window, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                      Strides{st[6], st[7], st[8]});
}

template <int D>
int launch_bf16(const plan::Plan& p, const void* q, const void* k, const void* v, void* o,
                int sq, int sk, int heads, int kv_heads, int causal, int window,
                const long long* st, cudaStream_t stream) {
  return plan::launch(flash_fwd_mma_kernel<D>, p, stream,
                      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
                      sk, heads, heads / kv_heads, causal, window, Strides{st[0], st[1], st[2]},
                      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]});
}

using Launch = int (*)(const plan::Plan&, const void*, const void*, const void*, void*, int,
                       int, int, int, int, int, const long long*, cudaStream_t);

Launch pick(int dtype, int d) {
  const bool f32 = dtype == 0;
  switch (d) {
    case 32: return f32 ? &launch_f32<32> : &launch_bf16<32>;
    case 64: return f32 ? &launch_f32<64> : &launch_bf16<64>;
    case 128: return f32 ? &launch_f32<128> : &launch_bf16<128>;
    default: return nullptr;
  }
}

const plan::Kernel kKernels[] = {
    {"flash_fwd_kernel<32>", reinterpret_cast<const void*>(&flash_fwd_kernel<32>)},
    {"flash_fwd_kernel<64>", reinterpret_cast<const void*>(&flash_fwd_kernel<64>)},
    {"flash_fwd_kernel<128>", reinterpret_cast<const void*>(&flash_fwd_kernel<128>)},
    {"flash_fwd_mma_kernel<32>", reinterpret_cast<const void*>(&flash_fwd_mma_kernel<32>)},
    {"flash_fwd_mma_kernel<64>", reinterpret_cast<const void*>(&flash_fwd_mma_kernel<64>)},
    {"flash_fwd_mma_kernel<128>", reinterpret_cast<const void*>(&flash_fwd_mma_kernel<128>)}};

}  // namespace

PLAN_KERNEL_TABLE(flash_attn, kKernels)

// q: (batch, sq, heads, d), k and v: (batch, sk, kv_heads, d), each with
// element strides st[0..2] (q), st[3..5] (k), st[6..8] (v) over its batch,
// sequence and head axes and d contiguous; o: contiguous (batch, sq, heads,
// d) of the same type.  dtype 0 is float32, 1 bfloat16 (then every stride
// even and every pointer 4-byte aligned: the kernel reads bf16 pairs); d
// is 32, 64 or 128; heads a multiple of kv_heads; sk >= 1.  The plan
// (attn_kernel.launch_plan): a block of kThreads threads per (query tile of
// kBQ rows, head, batch), grid (query tiles, heads, batch); for float32 the
// k and v tiles (and at d = 128 the q rows) in dynamic shared memory, opted
// in above 48 KB.  Refuses
// another block, or too little shared memory for the float32 tiles.
// Returns cudaGetLastError() after the launch (0 on success); a grid past
// the card's limits (heads or batch above 65535) is refused there.
extern "C" int flash_attn_launch(const plan::Plan* p, const void* q, const void* k,
                                 const void* v, void* o, int dtype, int d, int batch,
                                 int sq, int sk, int heads, int kv_heads, int causal,
                                 int window, const long long* st, void* stream) {
  if (batch == 0 || sq == 0 || heads == 0) return 0;
  const Launch fn = dtype == 0 || dtype == 1 ? pick(dtype, d) : nullptr;
  if (fn == nullptr || sk < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      p->block[0] != kThreads || p->block[1] != 1 || p->block[2] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(*p, q, k, v, o, sq, sk, heads, kv_heads, causal, window, st,
            static_cast<cudaStream_t>(stream));
}
