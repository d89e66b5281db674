// Per-row Enhanced ERA (SCARLET Eq. 4) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/era_kernel.py::_era_kernel
// (wrapper enhanced_era, pallas_call at era_kernel.py:78):
//     (B, N) averaged soft-labels, float32 or bfloat16 -> (B, N), same dtype
//     v   = log(max(float(z), 1e-12)) * beta
//     out = exp(v - rowmax(v)) / rowsum(exp(v - rowmax(v)))
// in that order of operations, in float32, over the N real classes.  (The
// Pallas wrapper zero-pads N to 128 lanes, and at beta < 1 those lanes
// keep some of the mass; Eq. 4 and the reference's oracle have none.)
//
// What bounds it on the card: bytes, and close behind them the issue of
// the precise log, exp and division.  The function reads B*N values and
// writes B*N.  Per value it does a clamp, a log, a multiply, an exp and a
// division: at whisper's (1536, 51968) float32 that is 638.6 MB, 0.19 ms
// at 3.35 TB/s, and about 67 instructions a value in the one-pass layout
// below (34 of them in the load loop, with the precise log;
// tools/kernel_variants.py counts them in the machine code), 0.16 ms at
// the H100's issue rate; in bfloat16 the bytes halve and the issue binds.
// So the layout reads each row from device memory once and writes it
// once, and computes each log, exp and division once.
//
// Layouts (chosen by era_kernel.rows_launch_plan from N alone, so that a
// row's result never depends on B, on the dtype or on how the rows are
// split between launches):
//
// - N <= 1024 (the paper's N = 10): era_rows_warp, a warp a row,
//   blockDim / 32 rows a block, three short passes over the row (it stays
//   in L1).  At (1000, 10) the launch takes the launch floor.
// - N up to what a cluster of 8 blocks holds: era_rows_onepass<T, C>, one
//   row a thread-block cluster of C blocks (C = 1, 2, 4 or 8), each block
//   holding a slice of `slice` values of the row in shared memory as
//   float32 v.  A block
//     1. reads its slice once with 16-byte loads (four in flight a
//        thread; the unaligned head and tail of a slice scalar-wise),
//        computes v and the slice's max and keeps v in shared memory;
//     2. combines the blocks' maxima over distributed shared memory;
//     3. replaces v by e = exp(v - max) and sums e;
//     4. combines the blocks' sums over distributed shared memory, in
//        rank order;
//     5. writes e / sum with 16-byte stores.
//   Shared memory is indexed so that the 16-byte aligned elements of the
//   input land on 16-byte aligned words, whatever the row's alignment
//   (N need not be a multiple of 4 or 8).  With C blocks a row, slices of
//   several rows share a multiprocessor, so one row's loads overlap
//   another's exps and divisions; the plan takes slices of at most 13312
//   values (52 KB, four blocks a multiprocessor), the size measured
//   fastest at whisper's vocabulary: C = 4 there (PERF.md).
// - N above that: era_rows_passes, one block a row and three passes over
//   the row (max, sum of exp, write), recomputing v in each; the second
//   and third reads come from L2 only while the rows in flight fit there.
//   No shape on the port's paths takes it.
//
// Reductions use a fixed tree: an xor-shuffle butterfly in each warp
// (every lane ends with the same value), then warp 0 combines the warps'
// partials in warp order, then (clusters) thread 0 of each block combines
// the blocks' results in rank order.  Each thread sums the slice elements
// t, t + blockDim, ... in order, a split of the elements by index, not by
// address, so the float32 and bfloat16 kernels sum the same values in the
// same order and a row's result does not depend on timing.
//
// beta is a float argument or, when beta_ptr is not null, a float32 on the
// card read by every thread: a CUDA tensor beta costs no host sync.
//
// Built with -fmad=false (no FMA contraction) and without fast math:
// logf/expf and the division are the precise library versions.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "plan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-12f;
constexpr int kOnepassThreads = 1024;  // threads a multiprocessor, over its blocks
constexpr int kInFlight = 4;           // 16-byte loads in flight a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// v of one value; a NaN passes the clamp, as through jnp.maximum
__device__ __forceinline__ float log_beta(float x, float beta) {
  return logf(x < kEps ? kEps : x) * beta;
}

template <typename T>
__device__ __forceinline__ float log_beta(const T* z, int j, float beta) {
  return log_beta(to_f32(z[j]), beta);
}

// 16 bytes of T: 4 floats or 8 bfloat16, unpacked to and packed from float.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bfloat16 is the upper half of the float32 of the same value
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pair(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
};

// Elements of T from p to the next 16-byte boundary, at most len.
template <typename T>
__device__ __forceinline__ int head_elems(const T* p, int len) {
  const int bytes = static_cast<int>((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u);
  return min(bytes / static_cast<int>(sizeof(T)), len);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max (kMax) or sum of v, returned to every thread.
template <bool kMax>
__device__ float block_reduce(float v, float* part, float* bcast) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? part[lane] : (kMax ? -INFINITY : 0.0f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) *bcast = w;
  }
  __syncthreads();
  const float r = *bcast;
  __syncthreads();  // part and bcast are written again by the next reduction
  return r;
}

// A block's max (kMax) or sum combined with its cluster's other blocks',
// in rank order, through `slot` in each block's shared memory; every
// thread of the cluster gets the same bits.
template <int C, bool kMax>
__device__ float cluster_combine(float v, float* slot, float* bcast) {
  if constexpr (C == 1) {
    return v;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) *slot = v;
    cluster.sync();  // every block's slot is written and visible
    if (threadIdx.x == 0) {
      float r = kMax ? -INFINITY : 0.0f;
#pragma unroll
      for (int b = 0; b < C; ++b) {
        const float x = *cluster.map_shared_rank(slot, b);
        r = kMax ? fmaxf(r, x) : r + x;
      }
      *bcast = r;
    }
    __syncthreads();
    const float r = *bcast;
    __syncthreads();
    return r;
  }
}

// One warp per row.
template <typename T>
__global__ void era_rows_warp(const T* __restrict__ z, T* __restrict__ out,
                              long long rows, int n, float beta_val,
                              const float* __restrict__ beta_ptr) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float beta = beta_ptr ? *beta_ptr : beta_val;
  const T* zr = z + row * n;
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, log_beta(zr, j, beta));
  m = warp_max(m);
  float s = 0.0f;
  for (int j = lane; j < n; j += 32) s += expf(log_beta(zr, j, beta) - m);
  s = warp_sum(s);
  T* orow = out + row * n;
  for (int j = lane; j < n; j += 32) store(orow + j, expf(log_beta(zr, j, beta) - m) / s);
}

// One row a cluster of C blocks, each block holding `slice` values of it.
template <typename T, int C>
__global__ void __launch_bounds__(kOnepassThreads / C, C)
    era_rows_onepass(const T* __restrict__ z, T* __restrict__ out, int n, int slice,
                     float beta_val, const float* __restrict__ beta_ptr) {
  extern __shared__ float4 smem4[];
  __shared__ float part[32];
  __shared__ float bcast;
  __shared__ float slot_max, slot_sum;  // read by the cluster's other blocks
  using P = Pack<T>;
  constexpr int V = P::kN;  // elements a 16-byte vector
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rank = static_cast<int>(blockIdx.x % C);  // the block's rank in its cluster
  const long long row = blockIdx.x / C;
  const int lo = min(rank * slice, n);
  const int len = min(lo + slice, n) - lo;
  const float beta = beta_ptr ? *beta_ptr : beta_val;
  const T* zs = z + row * n + lo;
  T* os = out + row * n + lo;

  // slice element i lives at sl[i]; the shift puts the elements at 16-byte
  // aligned addresses on multiples of V, so they move as float4s
  const int zhead = head_elems(zs, len);
  float* sl = reinterpret_cast<float*>(smem4) + (V - zhead) % V;

  // 1. v = log(max(z, eps)) * beta into shared memory; the block's max
  float m = -INFINITY;
  if (tid < zhead) {
    const float v = log_beta(zs, tid, beta);
    sl[tid] = v;
    m = v;
  }
  const int nvec = (len - zhead) / V;
  const uint4* zv = reinterpret_cast<const uint4*>(zs + zhead);
  float4* sv = reinterpret_cast<float4*>(sl + zhead);
  for (int i0 = tid; i0 < nvec; i0 += kInFlight * nthr) {
    uint4 raw[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * nthr;
      if (i < nvec) raw[u] = __ldcs(zv + i);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * nthr;
      if (i < nvec) {
        float f[V];
        P::unpack(raw[u], f);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          f[k] = log_beta(f[k], beta);
          m = fmaxf(m, f[k]);
        }
#pragma unroll
        for (int k = 0; k < V / 4; ++k) {
          sv[i * (V / 4) + k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
        }
      }
    }
  }
  for (int i = zhead + nvec * V + tid; i < len; i += nthr) {
    const float v = log_beta(zs, i, beta);
    sl[i] = v;
    m = fmaxf(m, v);
  }
  m = block_reduce<true>(m, part, &bcast);  // its barriers also publish sl
  m = cluster_combine<C, true>(m, &slot_max, &bcast);

  // 2. e = exp(v - max) in place; the block's sum, element i to thread i % nthr
  float s = 0.0f;
#pragma unroll 4
  for (int i = tid; i < len; i += nthr) {
    const float e = expf(sl[i] - m);
    sl[i] = e;
    s += e;
  }
  s = block_reduce<false>(s, part, &bcast);
  s = cluster_combine<C, false>(s, &slot_sum, &bcast);

  // 3. out = e / sum, 16-byte stores; the output's aligned elements fall
  // on aligned shared-memory words when z and out share their alignment
  const int ohead = head_elems(os, len);
  if (tid < ohead) store(os + tid, sl[tid] / s);
  const int onvec = (len - ohead) / V;
  uint4* ov = reinterpret_cast<uint4*>(os + ohead);
  const float* se = sl + ohead;
  const bool aligned = ((reinterpret_cast<uintptr_t>(se) & 15u) == 0);
  for (int i = tid; i < onvec; i += nthr) {
    float f[V];
    if (aligned) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(se + i * V)[k];
        f[4 * k] = q.x;
        f[4 * k + 1] = q.y;
        f[4 * k + 2] = q.z;
        f[4 * k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = se[i * V + k];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = f[k] / s;
    __stcs(ov + i, P::pack(f));
  }
  for (int i = ohead + onvec * V + tid; i < len; i += nthr) store(os + i, sl[i] / s);
  if constexpr (C > 1) cg::this_cluster().sync();  // the slots stay readable until all have read
}

// One block per row, three passes over it.
template <typename T>
__global__ void era_rows_passes(const T* __restrict__ z, T* __restrict__ out, int n,
                                float beta_val, const float* __restrict__ beta_ptr) {
  __shared__ float part[32];
  __shared__ float bcast;
  const long long row = blockIdx.x;
  const float beta = beta_ptr ? *beta_ptr : beta_val;
  const T* zr = z + row * n;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, log_beta(zr, j, beta));
  m = block_reduce<true>(m, part, &bcast);
  float s = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) s += expf(log_beta(zr, j, beta) - m);
  s = block_reduce<false>(s, part, &bcast);
  T* orow = out + row * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    store(orow + j, expf(log_beta(zr, j, beta) - m) / s);
  }
}

template <typename T>
int launch(const plan::Plan& p, int layout, const void* z, void* out, long long rows, int n,
           int slice, float beta, const void* beta_ptr, cudaStream_t stream) {
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  const float* bp = static_cast<const float*>(beta_ptr);
  switch (layout) {
    case 0: return plan::launch(era_rows_warp<T>, p, stream, zt, ot, rows, n, beta, bp);
    case 1:
      switch (p.cluster[0]) {
        case 1: return plan::launch(era_rows_onepass<T, 1>, p, stream, zt, ot, n, slice, beta, bp);
        case 2: return plan::launch(era_rows_onepass<T, 2>, p, stream, zt, ot, n, slice, beta, bp);
        case 4: return plan::launch(era_rows_onepass<T, 4>, p, stream, zt, ot, n, slice, beta, bp);
        case 8: return plan::launch(era_rows_onepass<T, 8>, p, stream, zt, ot, n, slice, beta, bp);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    default: return plan::launch(era_rows_passes<T>, p, stream, zt, ot, n, beta, bp);
  }
}

#define ONEPASS(T, name)                                                              \
  {"era_rows_onepass<" name ",1>", reinterpret_cast<const void*>(&era_rows_onepass<T, 1>)}, \
  {"era_rows_onepass<" name ",2>", reinterpret_cast<const void*>(&era_rows_onepass<T, 2>)}, \
  {"era_rows_onepass<" name ",4>", reinterpret_cast<const void*>(&era_rows_onepass<T, 4>)}, \
  {"era_rows_onepass<" name ",8>", reinterpret_cast<const void*>(&era_rows_onepass<T, 8>)}

const plan::Kernel kKernels[] = {
    {"era_rows_warp<float>", reinterpret_cast<const void*>(&era_rows_warp<float>)},
    {"era_rows_warp<bf16>", reinterpret_cast<const void*>(&era_rows_warp<__nv_bfloat16>)},
    ONEPASS(float, "float"),
    ONEPASS(__nv_bfloat16, "bf16"),
    {"era_rows_passes<float>", reinterpret_cast<const void*>(&era_rows_passes<float>)},
    {"era_rows_passes<bf16>", reinterpret_cast<const void*>(&era_rows_passes<__nv_bfloat16>)}};

#undef ONEPASS

}  // namespace

PLAN_KERNEL_TABLE(era_rows, kKernels)

// z, out: contiguous (rows, n) of one dtype (0 float32, 1 bfloat16).  beta_ptr,
// when not null, points to a float32 on the card and replaces beta.  layout 0
// is a warp a row (era_rows_warp, block / 32 rows a block); 1 a cluster of
// plan.cluster[0] (1, 2, 4 or 8) blocks a row, `slice` values each, in
// era_rows_onepass (the plan's grid is rows * cluster blocks); 2 a block a
// row (era_rows_passes).  The plan's grid covers the rows
// (era_kernel.rows_launch_plan).  Refuses a block that is not whole warps,
// and a slice that does not cover the row.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int era_rows_launch(const plan::Plan* p, const void* z, void* out, int dtype,
                               int layout, long long rows, int n, int slice, float beta,
                               const void* beta_ptr, void* stream) {
  if (rows == 0) return 0;
  const long long threads = plan::threads(*p);
  if (threads <= 0 || threads % 32 != 0 || p->block[1] != 1 || p->block[2] != 1 || n <= 0 ||
      layout < 0 || layout > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layout == 1 && (slice <= 0 || slice * p->cluster[0] < n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(*p, layout, z, out, rows, n, slice, beta, beta_ptr, s);
    case 1: return launch<__nv_bfloat16>(*p, layout, z, out, rows, n, slice, beta, beta_ptr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
