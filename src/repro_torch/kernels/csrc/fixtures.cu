// The static analyzer's three fixture kernels, for sm_90a.
//
// Replace the TPU kernels of src/repro/analysis/fixtures.py: _misaligned
// (pallas_call at fixtures.py:127), _vmem_scalar (:137) and _vmem_hog
// (:148).  There each fixture is a correct kernel body (_copy_kernel,
// _scale_kernel) under a BlockSpec that a native compile cannot take: a
// 10-row block off the 8-row sublane tile, a scalar in VMEM instead of
// SMEM, a 16 MiB block in and out past a core's VMEM.  Here too each body
// is correct, and what carries the fault is the launch plan a wrapper
// gives it (repro_torch.kernels.fixture_kernel):
//
//   copy_vec4  out = x, one float4 (16 bytes) a thread.  Its fault: a view
//              that starts 4 bytes into its storage, so the float4 loads
//              are misaligned (the card stops the kernel with
//              cudaErrorMisalignedAddress, 716, which is sticky).
//   scale      out = x * s, s read from the card through a pointer or
//              passed by value.  Its fault: the value read to the host from
//              a tensor on the card before every launch (a host sync).
//   copy_smem  out = x through a (rows, cols) tile of dynamic shared memory
//              in and another out.  Its fault: a (4096, 1024) float32 tile,
//              32 MiB of shared memory where a block gets at most 227 KB
//              (the card refuses the launch: cudaErrorInvalidValue, not
//              sticky).
//
// What bounds them on the card: bytes (a read and a write per value, at
// most a multiply).  They are fixtures, not a hot path: each is as simple
// as it can be and still have the fault its plan carries.
//
// The library also reads the card's own limits (fixtures_device_limits),
// which repro_torch.kernels.runtime.HOPPER is held against.
#include <cuda_runtime.h>

#include "plan.cuh"

namespace {

// n4 float4 values; the last n % 4 floats by the plain copy (here: none, the
// wrapper takes a multiple of 4).
__global__ void copy_vec4_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                 long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n4) out[i] = x[i];
}

__global__ void scale_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                             float s_val, const float* __restrict__ s_ptr) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float s = s_ptr ? *s_ptr : s_val;
  out[i] = x[i] * s;
}

// A block copies one (tile_rows, tile_cols) tile of the contiguous
// (rows, cols) x: into shared memory, across to a second tile, and out.
__global__ void copy_smem_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 long long rows, long long cols, int tile_rows,
                                 int tile_cols) {
  extern __shared__ float tiles[];  // 2 * tile_rows * tile_cols
  const long long tile = static_cast<long long>(tile_rows) * tile_cols;
  float* in_tile = tiles;
  float* out_tile = tiles + tile;
  const long long r0 = static_cast<long long>(blockIdx.y) * tile_rows;
  const long long c0 = static_cast<long long>(blockIdx.x) * tile_cols;
  for (long long e = threadIdx.x; e < tile; e += blockDim.x) {
    const long long r = r0 + e / tile_cols, c = c0 + e % tile_cols;
    in_tile[e] = r < rows && c < cols ? x[r * cols + c] : 0.0f;
  }
  __syncthreads();
  for (long long e = threadIdx.x; e < tile; e += blockDim.x) out_tile[e] = in_tile[e];
  __syncthreads();
  for (long long e = threadIdx.x; e < tile; e += blockDim.x) {
    const long long r = r0 + e / tile_cols, c = c0 + e % tile_cols;
    if (r < rows && c < cols) out[r * cols + c] = out_tile[e];
  }
}

const plan::Kernel kKernels[] = {
    {"copy_vec4_kernel", reinterpret_cast<const void*>(&copy_vec4_kernel)},
    {"scale_kernel", reinterpret_cast<const void*>(&scale_kernel)},
    {"copy_smem_kernel", reinterpret_cast<const void*>(&copy_smem_kernel)}};

}  // namespace

PLAN_KERNEL_TABLE(fixtures, kKernels)

// x, out: n4 float4 values (x as the wrapper hands it: not checked for
// alignment, which is the fixture's point).
extern "C" int copy_vec4_launch(const plan::Plan* p, const void* x, void* out, long long n4,
                                void* stream) {
  if (n4 == 0) return 0;
  return plan::launch(copy_vec4_kernel, *p, static_cast<cudaStream_t>(stream),
                      static_cast<const float4*>(x), static_cast<float4*>(out), n4);
}

// x, out: n contiguous floats; s_ptr, when not null, a float32 on the card
// that replaces s_val.
extern "C" int scale_launch(const plan::Plan* p, const void* x, void* out, long long n,
                            float s_val, const void* s_ptr, void* stream) {
  if (n == 0) return 0;
  return plan::launch(scale_kernel, *p, static_cast<cudaStream_t>(stream),
                      static_cast<const float*>(x), static_cast<float*>(out), n, s_val,
                      static_cast<const float*>(s_ptr));
}

// x, out: contiguous (rows, cols) float32; the plan's grid is (column
// tiles, row tiles) and its shared memory two tiles.  Refuses a plan whose
// shared memory cannot hold them.
extern "C" int copy_smem_launch(const plan::Plan* p, const void* x, void* out, long long rows,
                                long long cols, int tile_rows, int tile_cols, void* stream) {
  if (rows == 0 || cols == 0) return 0;
  if (tile_rows < 1 || tile_cols < 1 ||
      p->smem < 2LL * tile_rows * tile_cols * static_cast<long long>(sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return plan::launch(copy_smem_kernel, *p, static_cast<cudaStream_t>(stream),
                      static_cast<const float*>(x), static_cast<float*>(out), rows, cols,
                      tile_rows, tile_cols);
}

// The card's limits, in runtime.DEVICE_LIMITS order, from
// cudaDeviceGetAttribute on `device`.
extern "C" int fixtures_device_limits(int device, long long* out) {
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrMaxThreadsPerBlock,        cudaDevAttrMaxBlockDimX,
      cudaDevAttrMaxBlockDimY,              cudaDevAttrMaxBlockDimZ,
      cudaDevAttrMaxGridDimX,               cudaDevAttrMaxGridDimY,
      cudaDevAttrMaxGridDimZ,               cudaDevAttrMaxSharedMemoryPerBlock,
      cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxRegistersPerBlock,      cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrWarpSize};
  for (int i = 0; i < static_cast<int>(sizeof(attrs) / sizeof(attrs[0])); ++i) {
    int v = 0;
    const cudaError_t e = cudaDeviceGetAttribute(&v, attrs[i], device);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[i] = v;
  }
  return 0;
}
