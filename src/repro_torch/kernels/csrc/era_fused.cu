// Fused client mean + Enhanced-ERA sharpening (SCARLET Eq. 4) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/era_kernel.py::_era_fused_kernel
// (wrapper enhanced_era_fused, pallas_call at era_kernel.py:111):
//     (K, B, N) client soft-labels -> (B, N)
//     zbar = sum_k z[k] / K
//     v    = log(max(zbar, 1e-12)) * beta
//     out  = exp(v - rowmax(v)) / rowsum(exp(v - rowmax(v)))
// in exactly that order of operations.
//
// What bounds it on the card: bytes.  It reads K*B*N floats once and
// writes B*N; the arithmetic per byte is a handful of flops, far below the
// H100's flop/byte ridge.  The TPU kernel kept the whole (K, bb, N) block
// in VMEM; here the client axis is streamed instead: each thread owns one
// (row, class) element of a block's row chunk and walks k = 0..K-1 with
// loads that are contiguous across neighbouring threads (one coalesced
// 128-byte line per warp per client), so no K-sized tile is ever held.
// The per-row log values sit in shared memory (rows_per_block * N floats),
// where one thread per row takes the row max and the row sum sequentially.
// Every row is reduced in the same order whatever the row blocking, so the
// result does not depend on rows_per_block.
//
// Simple first version: one block per row chunk, no K split across
// threads, so at small B few SMs are busy and each thread's K-long load
// chain is latency bound.  Splitting K across warps is later work.
//
// That layout (era_fused_kernel) holds a row's N log values in the 48 KB
// of shared memory a block gets without opting in: N <= 12288.  Wider rows
// (an LM's vocabulary as classes; era_kernel.fused_layout, from N alone)
// take two launches: era_fused_mean writes zbar, the client mean, into a
// (B, N) float32 workspace the wrapper makes, a thread an element with
// loads coalesced across the classes, k walking 0..K-1 in order; then
// era_rows.cu sharpens the workspace in its own layout for N (a row over a
// thread-block cluster, or three passes past eight slices).  That moves
// 2 * B * N * 4 bytes more than one kernel would, and takes every N.
//
// Both layouts add an element's K clients in the same order (k = 0, 1,
// ..., from 0.0f) and divide the same way, so zbar and v have the same
// bits in both; the row's max is exact in any order; only the row sum of
// exp differs between layouts, at float32 rounding.  The layout depends on
// N alone, so a row's result never depends on B or on how the rows are
// split between launches.
//
// Built with -fmad=false (no FMA contraction) and without fast math:
// logf/expf and the division are the precise library versions.
#include <cuda_runtime.h>

#include "plan.cuh"

namespace {

constexpr int kInFlight = 4;  // elements a thread of era_fused_mean sums at once

__global__ void era_fused_kernel(const float* __restrict__ z,
                                 float* __restrict__ out,
                                 int k_clients, long long rows, int n,
                                 int rows_per_block, float beta) {
  extern __shared__ float vals[];  // rows_per_block * n
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = rows - row0;
  const int nrows = left < rows_per_block ? static_cast<int>(left)
                                          : rows_per_block;
  const int elems = nrows * n;
  const long long plane = rows * static_cast<long long>(n);  // client stride
  const float* zb = z + row0 * n;

  // pass 1: stream the client axis; sum, /K, clamp, log, *beta
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < k_clients; ++k) {
      acc += zb[static_cast<long long>(k) * plane + e];
    }
    const float zbar = acc / static_cast<float>(k_clients);
    vals[e] = logf(fmaxf(zbar, 1e-12f)) * beta;
  }
  __syncthreads();

  // pass 2: one thread per row: max, exp(v - max), sum, divide
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    float* v = vals + r * n;
    float m = v[0];
    for (int j = 1; j < n; ++j) m = fmaxf(m, v[j]);
    float s = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float e = expf(v[j] - m);
      v[j] = e;
      s += e;
    }
    for (int j = 0; j < n; ++j) v[j] = v[j] / s;
  }
  __syncthreads();

  // coalesced store of the chunk
  float* ob = out + row0 * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) ob[e] = vals[e];
}

// zbar = sum_k z[k] / K of `total` elements, kInFlight elements a thread
// (their loads interleaved, each element's sum in k order from 0.0f).
__global__ void era_fused_mean(const float* __restrict__ z, float* __restrict__ zbar,
                               int k_clients, long long total) {
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x * kInFlight + threadIdx.x;
  float acc[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) acc[u] = 0.0f;
  for (int k = 0; k < k_clients; ++k) {
    const float* zk = z + static_cast<long long>(k) * total;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = i0 + static_cast<long long>(u) * blockDim.x;
      if (i < total) acc[u] += __ldcs(zk + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const long long i = i0 + static_cast<long long>(u) * blockDim.x;
    if (i < total) zbar[i] = acc[u] / static_cast<float>(k_clients);
  }
}

const plan::Kernel kKernels[] = {
    {"era_fused_kernel", reinterpret_cast<const void*>(&era_fused_kernel)},
    {"era_fused_mean", reinterpret_cast<const void*>(&era_fused_mean)}};

}  // namespace

PLAN_KERNEL_TABLE(era_fused, kKernels)

// z: contiguous (k_clients, rows, n) float32; out: contiguous (rows, n).
// layout 0: era_fused_kernel, rows_per_block rows a block, their log
// values in the plan's dynamic shared memory, out the sharpened rows; 1:
// era_fused_mean, out the client mean zbar (the plan's grid covers rows *
// n elements, kInFlight a thread), for era_rows to sharpen
// (era_kernel.fused_launch_plan).  Refuses a plan its kernel cannot run:
// too little shared memory for its rows, a grid too small for the
// elements.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int era_fused_launch(const plan::Plan* p, const void* z, void* out, int layout,
                                int k_clients, long long rows, int n, int rows_per_block,
                                float beta, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  if (k_clients < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (layout == 0) {
    if (rows_per_block < 1 ||
        p->smem < static_cast<long long>(rows_per_block) * n * static_cast<long long>(sizeof(float))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return plan::launch(era_fused_kernel, *p, st, zf, of, k_clients, rows, n, rows_per_block,
                        beta);
  }
  const long long total = rows * n;
  if (layout != 1 || p->grid[0] * plan::threads(*p) * kInFlight < total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return plan::launch(era_fused_mean, *p, st, zf, of, k_clients, total);
}
