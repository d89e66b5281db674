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
// What bounds it on the card: bytes.  The function reads B*N values and
// writes B*N; per value it does a clamp, a log, a multiply, an exp and a
// division, far below the H100's flop/byte ridge.  The TPU kernel held a
// (block_b, N) tile in VMEM; here no row is held in shared memory, so any N
// works (whisper's 51968 classes included).  Instead each row is read
// three times from global memory, recomputing the log each time: the max
// of v, then the sum of exp(v - max), then the write.  The second and third
// reads of a row hit L2 only while the rows in flight fit in it; when they
// do not, the kernel moves up to twice the bound's bytes (three reads and
// a write against one of each).
//
// Layout (chosen by era_kernel.launch_plan): for N <= 1024 (the paper's
// N = 10) one warp per row, blockDim/32 rows per block; above, one block
// per row.  Reductions use a
// fixed tree: an xor-shuffle butterfly in each warp (every lane ends with
// the same value), then warp 0 combines the warps' partials in warp order,
// so a row's result does not depend on timing.
//
// beta is a float argument or, when beta_ptr is not null, a float32 on the
// card read by every thread: a CUDA tensor beta costs no host sync.
//
// Simple first version: scalar loads, three passes.  A later version could
// keep small rows in registers and read each row once.
//
// Built with -fmad=false (no FMA contraction) and without fast math:
// logf/expf and the division are the precise library versions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "plan.cuh"

namespace {

constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// v_j; a NaN passes the clamp, as through jnp.maximum
template <typename T>
__device__ __forceinline__ float log_beta(const T* z, int j, float beta) {
  const float x = to_f32(z[j]);
  return logf(x < kEps ? kEps : x) * beta;
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

// One block per row.
template <typename T>
__global__ void era_rows_block(const T* __restrict__ z, T* __restrict__ out, int n,
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
int launch(const plan::Plan& p, int layout, const void* z, void* out, long long rows,
           int n, float beta, const void* beta_ptr, cudaStream_t stream) {
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  const float* bp = static_cast<const float*>(beta_ptr);
  if (layout == 0) return plan::launch(era_rows_warp<T>, p, stream, zt, ot, rows, n, beta, bp);
  return plan::launch(era_rows_block<T>, p, stream, zt, ot, n, beta, bp);
}

const plan::Kernel kKernels[] = {
    {"era_rows_warp<float>", reinterpret_cast<const void*>(&era_rows_warp<float>)},
    {"era_rows_warp<bf16>", reinterpret_cast<const void*>(&era_rows_warp<__nv_bfloat16>)},
    {"era_rows_block<float>", reinterpret_cast<const void*>(&era_rows_block<float>)},
    {"era_rows_block<bf16>", reinterpret_cast<const void*>(&era_rows_block<__nv_bfloat16>)}};

}  // namespace

PLAN_KERNEL_TABLE(era_rows, kKernels)

// z, out: contiguous (rows, n) of one dtype (0 float32, 1 bfloat16).  beta_ptr,
// when not null, points to a float32 on the card and replaces beta.  layout 0
// is a warp a row (era_rows_warp, block / 32 rows a block), 1 a block a row
// (era_rows_block); the plan's grid covers the rows (era_kernel.launch_plan).
// Refuses a block that is not whole warps.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int era_rows_launch(const plan::Plan* p, const void* z, void* out, int dtype,
                               int layout, long long rows, int n, float beta,
                               const void* beta_ptr, void* stream) {
  if (rows == 0) return 0;
  const long long threads = plan::threads(*p);
  if (threads <= 0 || threads % 32 != 0 || p->block[1] != 1 || p->block[2] != 1 || n <= 0 ||
      layout < 0 || layout > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(*p, layout, z, out, rows, n, beta, beta_ptr, s);
    case 1: return launch<__nv_bfloat16>(*p, layout, z, out, rows, n, beta, beta_ptr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
