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
// The client sum: the K clients fall into G = min(K, kSplit) fixed
// subsets, subset s the clients s, s + G, s + 2G, ..., each summed in k
// order from 0.0f; then the G subsets' sums are added in order s = 0, 1,
// ..., G - 1 from 0.0f, and the total divided by K.  G and the order
// depend on K alone (era_kernel.client_subsets), never on B, the layout or
// how the rows are split between launches, so every layout below gives
// zbar and v the same bits for the same (K, N), and a row's result never
// depends on B or on the rows beside it.  The row's max is exact in any
// order; the row sum of exp is a warp's: each lane adds the classes j =
// lane, lane + 32, ... in order, then an xor-shuffle butterfly, an order
// fixed by N.
//
// What bounds it on the card: bytes.  It reads K*B*N floats once and
// writes B*N; the arithmetic per byte is a handful of flops, far below the
// H100's flop/byte ridge.  At the slice's (100, 1000, 10) the stack is 4.0
// MB, 1.2 us at 3.35 TB/s, and the kernel is bound by how many loads are
// in flight: the TPU kernel kept the whole (K, bb, N) block in VMEM, and a
// thread that sums an element's K clients from device memory waits K
// times.  Three layouts, from N alone (era_kernel.fused_layout):
//
// - Tile (era_fused_kernel, N <= 32; the slice): a block of 512 threads
//   owns a tile of `tile` rows (tile * N <= 64 values: 4 rows at N = 10,
//   so 250 blocks for the slice's 1000 rows, two a multiprocessor).  A
//   client's tile is tile * N contiguous floats; thread (s, e) sums value
//   e of subset s's clients straight from device memory, its about K / G
//   loads independent and in flight together, the threads of a warp on
//   consecutive floats of a client's tile: G x tile x N sums of K / G
//   terms where one thread summed K.  Then a warp a row, a lane a class,
//   adds the G subset sums in order, takes the log and sharpens (max and
//   sum by xor-shuffle butterflies), and writes the row.  Staging the
//   clients' tiles in shared memory with 16-byte cp.async first (as
//   fused_round.cu's tile layout does) measured no faster (PERF.md,
//   section 6) and is not done.
// - Rows (era_fused_rows, 32 < N <= 12288): a block owns a chunk of rows
//   whose N log values fit the 48 KB a block gets without opting in, a
//   thread a (row, class) value summing its G subsets from device memory
//   (loads coalesced across the classes), then a warp a row sharpens.
// - Wide (N > 12288, an LM's vocabulary as classes): era_fused_mean writes
//   zbar into a (B, N) float32 workspace the wrapper makes, a thread
//   kInFlight values each summing its G subsets, loads coalesced across
//   the classes; then era_rows.cu sharpens the workspace in its own layout
//   for N (a row over a thread-block cluster, or three passes past eight
//   slices).  That moves 2 * B * N * 4 bytes more than one kernel would,
//   and takes every N.  Only the row sum of exp differs between this
//   layout and the others, at float32 rounding.
//
// Built with -fmad=false (no FMA contraction) and without fast math:
// logf/expf and the division are the precise library versions.
#include <cuda_runtime.h>

#include "plan.cuh"

namespace {

constexpr int kSplit = 8;       // subsets of the client axis, at most (era_kernel.CLIENT_SPLIT)
constexpr int kInFlight = 4;    // elements a thread of era_fused_mean sums at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float sharpen_log(float total, int k_clients, float beta) {
  const float zbar = total / static_cast<float>(k_clients);
  return logf(fmaxf(zbar, 1e-12f)) * beta;
}

// The client sum of value i of a (K, plane) stack, subset by subset (see
// the header), by one thread.
__device__ __forceinline__ float client_sum(const float* __restrict__ z, long long plane,
                                            long long i, int k_clients) {
  const int groups = min(k_clients, kSplit);
  float total = 0.0f;
  for (int s = 0; s < groups; ++s) {
    float acc = 0.0f;
#pragma unroll 4
    for (int k = s; k < k_clients; k += groups) acc += z[static_cast<long long>(k) * plane + i];
    total += acc;
  }
  return total;
}

// Tile layout (N <= 32): the subsets' running sums [G][tile * n] in shared
// memory.
__global__ void era_fused_kernel(const float* __restrict__ z, float* __restrict__ out,
                                 int k_clients, long long rows, int n, int tile, float beta) {
  extern __shared__ float part[];
  const int groups = min(k_clients, kSplit);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * tile;
  const int rows_here = static_cast<int>(min(static_cast<long long>(tile), rows - row0));
  const int len = rows_here * n;  // a client's contiguous floats in the tile
  const long long plane = rows * static_cast<long long>(n);
  const float* zt = z + row0 * n;

  // thread (s, e): value e of subset s's clients (k % groups == s), in order
  for (int t = tid; t < groups * len; t += nthr) {
    const int s = t / len, e = t - s * len;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = s; k < k_clients; k += groups) acc += zt[static_cast<long long>(k) * plane + e];
    part[t] = acc;
  }
  __syncthreads();

  // a warp a row, a lane a class: the subsets' sums in order, the log,
  // then the sharpening
  for (int r = warp; r < rows_here; r += nwarps) {
    float x = -INFINITY;
    if (lane < n) {
      float total = 0.0f;
      for (int s = 0; s < groups; ++s) total += part[s * len + r * n + lane];
      x = sharpen_log(total, k_clients, beta);
    }
    const float m = warp_max(x);
    const float ex = lane < n ? expf(x - m) : 0.0f;
    const float s = warp_sum(ex);
    if (lane < n) out[(row0 + r) * n + lane] = ex / s;
  }
}

// Rows layout (32 < N <= 12288): rows_per_block rows a block, their N log
// values in shared memory.
__global__ void era_fused_rows(const float* __restrict__ z, float* __restrict__ out,
                               int k_clients, long long rows, int n, int rows_per_block,
                               float beta) {
  extern __shared__ float vals[];  // rows_per_block * n
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = rows - row0;
  const int nrows = left < rows_per_block ? static_cast<int>(left) : rows_per_block;
  const int elems = nrows * n;
  const long long plane = rows * static_cast<long long>(n);  // client stride
  const float* zb = z + row0 * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  for (int e = threadIdx.x; e < elems; e += blockDim.x)
    vals[e] = sharpen_log(client_sum(zb, plane, e, k_clients), k_clients, beta);
  __syncthreads();

  // a warp a row, the lanes striding the classes
  for (int r = warp; r < nrows; r += nwarps) {
    float* v = vals + r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, v[j]);
    m = warp_max(m);
    float s = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(v[j] - m);
      v[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < n; j += 32) v[j] = v[j] / s;
  }
  __syncthreads();

  // coalesced store of the chunk
  float* ob = out + row0 * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) ob[e] = vals[e];
}

// zbar = the client sum / K of `total` elements, kInFlight elements a
// thread (their loads interleaved, each element's subsets as client_sum).
__global__ void era_fused_mean(const float* __restrict__ z, float* __restrict__ zbar,
                               int k_clients, long long total) {
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x * kInFlight + threadIdx.x;
  const int groups = min(k_clients, kSplit);
  float sum[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) sum[u] = 0.0f;
  for (int s = 0; s < groups; ++s) {
    float acc[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) acc[u] = 0.0f;
    for (int k = s; k < k_clients; k += groups) {
      const float* zk = z + static_cast<long long>(k) * total;
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long i = i0 + static_cast<long long>(u) * blockDim.x;
        if (i < total) acc[u] += __ldcs(zk + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) sum[u] += acc[u];
  }
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const long long i = i0 + static_cast<long long>(u) * blockDim.x;
    if (i < total) zbar[i] = sum[u] / static_cast<float>(k_clients);
  }
}

const plan::Kernel kKernels[] = {
    {"era_fused_kernel", reinterpret_cast<const void*>(&era_fused_kernel)},
    {"era_fused_rows", reinterpret_cast<const void*>(&era_fused_rows)},
    {"era_fused_mean", reinterpret_cast<const void*>(&era_fused_mean)}};

}  // namespace

PLAN_KERNEL_TABLE(era_fused, kKernels)

// z: contiguous (k_clients, rows, n) float32; out: contiguous (rows, n).
// layout 0: era_fused_kernel (n <= 32), `tile` rows a block, the subsets'
// sums in the plan's dynamic shared memory; layout 1: era_fused_rows,
// `tile` rows a block, their log values in the plan's dynamic shared
// memory; both write the sharpened rows.  Layout 2: era_fused_mean, out
// the client mean zbar (the plan's grid covers rows * n elements,
// kInFlight a thread), for era_rows to sharpen
// (era_kernel.fused_launch_plan).  Refuses a plan its kernel cannot run:
// a block that is not whole warps, too little shared memory for its tile
// or its rows, a grid too small for the elements.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int era_fused_launch(const plan::Plan* p, const void* z, void* out, int layout,
                                int k_clients, long long rows, int n, int tile, float beta,
                                void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  if (k_clients < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = k_clients < kSplit ? k_clients : kSplit;
  if (layout == 0) {
    if (n > 32 || tile < 1 || plan::threads(*p) % 32 != 0 ||
        p->smem < 4 * groups * tile * static_cast<long long>(n)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return plan::launch(era_fused_kernel, *p, st, zf, of, k_clients, rows, n, tile, beta);
  }
  if (layout == 1) {
    if (tile < 1 || plan::threads(*p) % 32 != 0 ||
        p->smem < static_cast<long long>(tile) * n * static_cast<long long>(sizeof(float))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return plan::launch(era_fused_rows, *p, st, zf, of, k_clients, rows, n, tile, beta);
  }
  const long long total = rows * n;
  if (layout != 2 || p->grid[0] * plan::threads(*p) * kInFlight < total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return plan::launch(era_fused_mean, *p, st, zf, of, k_clients, total);
}
