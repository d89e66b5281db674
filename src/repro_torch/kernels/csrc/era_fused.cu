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
// Built with -fmad=false (no FMA contraction) and without fast math:
// logf/expf and the division are the precise library versions.
#include <cuda_runtime.h>

#include "plan.cuh"

namespace {

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

const plan::Kernel kKernels[] = {
    {"era_fused_kernel", reinterpret_cast<const void*>(&era_fused_kernel)}};

}  // namespace

PLAN_KERNEL_TABLE(era_fused, kKernels)

// z: contiguous (k_clients, rows, n) float32; out: contiguous (rows, n);
// rows_per_block rows a block, their log values in the plan's dynamic
// shared memory (era_kernel.launch_plan).  Refuses a plan whose shared
// memory cannot hold rows_per_block rows.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int era_fused_launch(const plan::Plan* p, const void* z, void* out,
                                int k_clients, long long rows, int n,
                                int rows_per_block, float beta, void* stream) {
  if (rows == 0) return 0;
  if (rows_per_block < 1 ||
      p->smem < static_cast<long long>(rows_per_block) * n * static_cast<long long>(sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return plan::launch(era_fused_kernel, *p, static_cast<cudaStream_t>(stream),
                      static_cast<const float*>(z), static_cast<float*>(out), k_clients,
                      rows, n, rows_per_block, beta);
}
