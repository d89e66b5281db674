// Per-row min-max quantize-dequantize round trip for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/quant_kernel.py::_qdq_kernel
// (wrapper quantize_dequantize, pallas_call at quant_kernel.py:65).  For
// each row over its n values, with levels = 2^bits - 1:
//     zmin, zmax = min, max of the row
//     scale = max(zmax - zmin, 1e-9)
//     q     = clamp(rint((z - zmin) / scale * levels) / levels, 0, 1)
//     out   = q * scale + zmin
// mirroring quant_kernel.py:35-43 operation for operation.  The [0, 1]
// clamp is kept (the TPU kernel is the contract; kernels/ref.py lacks it).
// rintf rounds half to even like jnp.round; roundf (half away from zero)
// would move a tied value by a whole quantization step.
//
// What bounds it on the card: bytes.  It reads rows * n floats and writes
// as many, with a few flops and two precise divisions a value.  On the
// main path the rows are the cache-delta residual view (z - base)[..., :-1]
// of the slice's (100, 1000, 10) stack: 100,000 rows of 9 values at a row
// stride of 10 floats, read in place (never copied), 7.2 MB, 2.15 us at
// 3.35 TB/s.  A thread a row reading its row straight from device memory
// would spread each warp-wide 4-byte load over 32 rows and read every row
// twice.
//
// Layouts (quant_kernel.layout picks one from n and the row stride ld):
//
// - qdq_tile, n <= 32 with ld <= 2n (the residual view): a block owns a
//   tile of consecutive rows.  It stages their contiguous span, from the
//   first row's first value to the last row's last (the gaps between rows
//   included), into shared memory with 16-byte asynchronous copies
//   (cp.async, all in flight at once), 4-byte ones at the span's unaligned
//   head and tail; the span sits in shared memory shifted
//   so that 16-byte aligned floats of the input land on 16-byte aligned
//   words.  Then a thread a row takes the row's min and max and its codes,
//   written into a second tile laid out as the output's contiguous (rows,
//   n), which the block stores with 16-byte stores (scalar at its head and
//   tail).  Every load and store of device memory is coalesced and each
//   input float is read once.
// - qdq_warp<V>, n <= 1024 (or a row stride too sparse to stage): a warp a
//   row, lane l holding values l, l + 32, ... (V of them) in registers,
//   min and max by an xor-shuffle butterfly.
// - qdq_block, wider rows: a block a row, min and max over the row (a
//   butterfly in each warp, then warp 0 over the warps), then the codes,
//   the row read a second time (from L1 or L2).
//
// Every layout gives the same bits: min and max are exact whatever their
// order, and each code is a function of its value, the row's min and the
// row's scale alone.  A 1- to 8-bit code reads rint(...) / levels from a
// table of i / levels, i = 0..levels, made by each block with the same
// precise division: the same quotient, read instead of divided (as
// fused_round.cu does).
//
// Built with -fmad=false, so `q * scale + zmin` is a rounded multiply then
// a rounded add, as in the reference, and never one fused multiply-add.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "plan.cuh"

namespace {

constexpr int kTableMax = 256;  // entries of the quotient table: codes of 1 to 8 bits
constexpr unsigned kFull = 0xffffffffu;

// The table of i / levels, i < table (0: no table), made by the block.
__device__ __forceinline__ void fill_table(float* tab, int table, float levels) {
  for (int i = threadIdx.x; i < table; i += blockDim.x) tab[i] = static_cast<float>(i) / levels;
}

// One value's round trip; tab holds i / levels for i <= levels when table
// is nonzero.  A NaN code takes the division (t / levels, then the clamp
// gives 0), as the reference's arithmetic does.
//
// The value equal to its row's min (one a row at least) has a zero
// dividend, and the precise division's fast path hands a zero dividend to
// its slow path (a call of some hundred instructions): in a warp of rows,
// nearly every class position has a lane there, and the whole warp would
// wait on it at every position.  0 / scale is +0 for every scale the row can
// have (at least 1e-9, or inf), so a zero dividend takes +0 without
// dividing, and every lane divides a nonzero dividend (1 in the zero
// lanes, whose quotient is not used).  The same bits as dividing: a -0
// dividend's -0 and +0 both code to level 0 and decode to 0 * scale + min.
__device__ __forceinline__ float round_trip(float v, float zmin, float scale, float levels,
                                            const float* tab, int table) {
  const float d = v - zmin;
  const bool zero = d == 0.0f;
  const float t = rintf((zero ? 0.0f : (zero ? 1.0f : d) / scale) * levels);
  float q = table != 0 && t >= 0.0f && t <= levels ? tab[static_cast<int>(t)] : t / levels;
  q = fminf(fmaxf(q, 0.0f), 1.0f);
  return q * scale + zmin;
}

// Asynchronous copies to shared memory: every copy of a tile is in flight
// at once, and no register holds the data on its way.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Floats from p to the next 16-byte boundary, at most len.
__device__ __forceinline__ int head_floats(const float* p, int len) {
  const int bytes = static_cast<int>((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u);
  return min(bytes / 4, len);
}

// The tile layout's shared memory in floats: the staged span of `tile`
// rows ((tile - 1) * ld + n floats, rounded up to 4, and 4 of shift), then
// the output tile (tile * n, rounded up to 4, and 4 of shift).  As
// quant_kernel.tile_smem computes it.
__host__ __device__ inline long long tile_in_floats(int tile, int n, long long ld) {
  return (((tile - 1) * ld + n + 3) & ~3LL) + 4;
}

__host__ __device__ inline long long tile_floats(int tile, int n, long long ld) {
  return tile_in_floats(tile, n, ld) + ((static_cast<long long>(tile) * n + 3) & ~3LL) + 4;
}

__global__ void qdq_tile(const float* __restrict__ z, float* __restrict__ out, long long rows,
                         int n, long long ld, int tile, float levels, int table) {
  extern __shared__ float4 smem4[];
  __shared__ float tab[kTableMax];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * tile;
  const int nr = static_cast<int>(min(static_cast<long long>(tile), rows - r0));
  fill_table(tab, table, levels);

  // the span of the tile's rows, staged with its 16-byte aligned floats on
  // 16-byte aligned words
  float* const sm = reinterpret_cast<float*>(smem4);
  const float* zs = z + r0 * ld;
  const int span = static_cast<int>((nr - 1) * ld) + n;
  const int zhead = head_floats(zs, span);
  float* in = sm + (4 - zhead) % 4;
  if (tid < zhead) cp_async4(in + tid, zs + tid);
  const int nvec = (span - zhead) >> 2;
  for (int i = tid; i < nvec; i += nthr) cp_async16(in + zhead + 4 * i, zs + zhead + 4 * i);
  for (int i = zhead + 4 * nvec + tid; i < span; i += nthr) cp_async4(in + i, zs + i);

  // the output tile, shifted the same way for the output's alignment
  float* og = out + r0 * n;
  const int total = nr * n;
  const int ohead = head_floats(og, total);
  float* ot = sm + tile_in_floats(tile, n, ld) + (4 - ohead) % 4;
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // a thread a row
  for (int r = tid; r < nr; r += nthr) {
    const float* zr = in + r * static_cast<int>(ld);
    float* o = ot + r * n;
    float zmin = INFINITY, zmax = -INFINITY;
    for (int j = 0; j < n; ++j) {
      zmin = fminf(zmin, zr[j]);
      zmax = fmaxf(zmax, zr[j]);
    }
    const float scale = fmaxf(zmax - zmin, 1e-9f);
    for (int j = 0; j < n; ++j) o[j] = round_trip(zr[j], zmin, scale, levels, tab, table);
  }
  __syncthreads();

  if (tid < ohead) og[tid] = ot[tid];
  const int onvec = (total - ohead) >> 2;
  float4* gv = reinterpret_cast<float4*>(og + ohead);
  const float4* tv = reinterpret_cast<const float4*>(ot + ohead);
  for (int i = tid; i < onvec; i += nthr) gv[i] = tv[i];
  for (int i = ohead + 4 * onvec + tid; i < total; i += nthr) og[i] = ot[i];
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A warp a row, V values a lane.
template <int V>
__global__ void qdq_warp(const float* __restrict__ z, float* __restrict__ out, long long rows,
                         int n, long long ld, float levels, int table) {
  __shared__ float tab[kTableMax];
  fill_table(tab, table, levels);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float* zr = z + row * ld;
  float x[V];
  float zmin = INFINITY, zmax = -INFINITY;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int j = lane + 32 * u;
    x[u] = j < n ? zr[j] : 0.0f;
    if (j < n) {
      zmin = fminf(zmin, x[u]);
      zmax = fmaxf(zmax, x[u]);
    }
  }
  zmin = warp_min(zmin);
  zmax = warp_max(zmax);
  const float scale = fmaxf(zmax - zmin, 1e-9f);
  float* o = out + row * n;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int j = lane + 32 * u;
    if (j < n) o[j] = round_trip(x[u], zmin, scale, levels, tab, table);
  }
}

// A block a row.
__global__ void qdq_block(const float* __restrict__ z, float* __restrict__ out, int n,
                          long long ld, float levels, int table) {
  __shared__ float tab[kTableMax];
  __shared__ float part[2][32];
  fill_table(tab, table, levels);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* zr = z + static_cast<long long>(blockIdx.x) * ld;
  float zmin = INFINITY, zmax = -INFINITY;
  for (int j = tid; j < n; j += blockDim.x) {
    zmin = fminf(zmin, zr[j]);
    zmax = fmaxf(zmax, zr[j]);
  }
  zmin = warp_min(zmin);
  zmax = warp_max(zmax);
  if (lane == 0) {
    part[0][warp] = zmin;
    part[1][warp] = zmax;
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  zmin = warp_min(lane < nwarps ? part[0][lane] : INFINITY);
  zmax = warp_max(lane < nwarps ? part[1][lane] : -INFINITY);
  const float scale = fmaxf(zmax - zmin, 1e-9f);
  float* o = out + static_cast<long long>(blockIdx.x) * n;
  for (int j = tid; j < n; j += blockDim.x) {
    o[j] = round_trip(zr[j], zmin, scale, levels, tab, table);
  }
}

#define WARP_KERNEL(v) {"qdq_warp<" #v ">", reinterpret_cast<const void*>(&qdq_warp<v>)}

const plan::Kernel kKernels[] = {
    {"qdq_tile", reinterpret_cast<const void*>(&qdq_tile)},
    WARP_KERNEL(1), WARP_KERNEL(2), WARP_KERNEL(4), WARP_KERNEL(8), WARP_KERNEL(16),
    WARP_KERNEL(32),
    {"qdq_block", reinterpret_cast<const void*>(&qdq_block)}};

#undef WARP_KERNEL

}  // namespace

PLAN_KERNEL_TABLE(qdq, kKernels)

// z: (rows, n) float32 with row stride ld and unit class stride; out:
// contiguous (rows, n).  layout 0 is qdq_tile (`tile` rows a block, the
// plan's shared memory holding tile_floats(tile, n, ld) floats), 1
// qdq_warp<vals> (a warp a row, vals of 1, 2, 4, ..., 32 with n <= 32 *
// vals), 2 qdq_block (a block a row).  table is 0 or levels + 1 <= 256
// (the quotient table).  The plan's grid covers the rows
// (quant_kernel.launch_plan).  Refuses a plan its kernel cannot run:
// too little shared memory, a block that is not whole warps (warp and
// block layouts), a warp too narrow for n, or a table of the wrong size.
// Returns cudaGetLastError() after the launch.
extern "C" int qdq_launch(const plan::Plan* p, const void* z, void* out, int layout,
                          long long rows, int n, long long ld, int tile, int vals, float levels,
                          int table, void* stream) {
  if (rows == 0) return 0;
  if (n < 1 || ld < 0 || table < 0 || table > kTableMax ||
      (table != 0 && table != static_cast<int>(levels) + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  if (layout == 0) {
    if (tile < 1 || p->smem < 4 * tile_floats(tile, n, ld)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return plan::launch(qdq_tile, *p, s, zf, of, rows, n, ld, tile, levels, table);
  }
  if (plan::threads(*p) % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (layout == 2) return plan::launch(qdq_block, *p, s, zf, of, n, ld, levels, table);
  if (layout != 1 || n > 32 * vals) return static_cast<int>(cudaErrorInvalidValue);
  switch (vals) {
    case 1: return plan::launch(qdq_warp<1>, *p, s, zf, of, rows, n, ld, levels, table);
    case 2: return plan::launch(qdq_warp<2>, *p, s, zf, of, rows, n, ld, levels, table);
    case 4: return plan::launch(qdq_warp<4>, *p, s, zf, of, rows, n, ld, levels, table);
    case 8: return plan::launch(qdq_warp<8>, *p, s, zf, of, rows, n, ld, levels, table);
    case 16: return plan::launch(qdq_warp<16>, *p, s, zf, of, rows, n, ld, levels, table);
    case 32: return plan::launch(qdq_warp<32>, *p, s, zf, of, rows, n, ld, levels, table);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
