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
// as it can be and still have the fault its plan carries, and each runs
// near a PyTorch call that does the same work.  So copy_smem's tile comes
// in by 16-byte asynchronous copies (cp.async, no registers on the way),
// crosses to the second tile by 16-byte shared-memory accesses and goes
// out by 16-byte stores, every index a 32-bit integer stepped without
// division (a 64-bit division and modulo an element would cost more than
// the copy); a matrix whose rows are not whole 16 bytes takes 4-byte
// copies.
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// A block copies one (tile_rows, tile_cols) tile of the contiguous
// (rows, cols) x: into shared memory with asynchronous copies, across to a
// second tile, and out.  V floats a copy: 4 (16-byte copies, where cols,
// tile_cols and x's start are whole 16 bytes) or 1.  Thread t takes the
// copies t, t + blockDim, ... of the tile in row-major order, its (row,
// copy) position stepped with 32-bit integers and no division past the
// first; copies past the matrix's edge are skipped (the tile's values
// there are never stored).
template <int V>
__global__ void copy_smem_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 long long rows, long long cols, int tile_rows, int tile_cols) {
  extern __shared__ float4 tiles4[];  // 2 * tile_rows * tile_cols floats
  const int tile = tile_rows * tile_cols;
  float* in_tile = reinterpret_cast<float*>(tiles4);
  float* out_tile = in_tile + tile;
  const long long r0 = static_cast<long long>(blockIdx.y) * tile_rows;
  const long long c0 = static_cast<long long>(blockIdx.x) * tile_cols;
  const int nr = static_cast<int>(min(static_cast<long long>(tile_rows), rows - r0));
  const int nc = static_cast<int>(min(static_cast<long long>(tile_cols), cols - c0));
  const float* xb = x + r0 * cols + c0;
  float* ob = out + r0 * cols + c0;
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int per_row = tile_cols / V;  // copies a tile row
  const int dr = nthr / per_row, dc = nthr - dr * per_row;
  const int r_first = tid / per_row, c_first = tid - r_first * per_row;

  for (int r = r_first, c = c_first; r < nr;) {
    if (c * V < nc) {
      float* dst = in_tile + r * tile_cols + c * V;
      const float* src = xb + static_cast<long long>(r) * cols + c * V;
      if constexpr (V == 4) {
        cp_async16(dst, src);
      } else {
        cp_async4(dst, src);
      }
    }
    c += dc;
    r += dr;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if constexpr (V == 4) {
    const float4* src = reinterpret_cast<const float4*>(in_tile);
    float4* dst = reinterpret_cast<float4*>(out_tile);
    for (int i = tid; i < tile / 4; i += nthr) dst[i] = src[i];
  } else {
    for (int i = tid; i < tile; i += nthr) out_tile[i] = in_tile[i];
  }
  __syncthreads();

  for (int r = r_first, c = c_first; r < nr;) {
    if (c * V < nc) {
      const float* src = out_tile + r * tile_cols + c * V;
      float* dst = ob + static_cast<long long>(r) * cols + c * V;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        *dst = *src;
      }
    }
    c += dc;
    r += dr;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

const plan::Kernel kKernels[] = {
    {"copy_vec4_kernel", reinterpret_cast<const void*>(&copy_vec4_kernel)},
    {"scale_kernel", reinterpret_cast<const void*>(&scale_kernel)},
    {"copy_smem_kernel<4>", reinterpret_cast<const void*>(&copy_smem_kernel<4>)},
    {"copy_smem_kernel<1>", reinterpret_cast<const void*>(&copy_smem_kernel<1>)}};

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
// tiles, row tiles) and its shared memory two tiles.  vec 4: 16-byte
// copies (the wrapper found cols, tile_cols and x's start whole 16 bytes),
// else 1.  Refuses a plan whose shared memory cannot hold the tiles, and a
// 16-byte plan on columns that are not whole 16 bytes.
extern "C" int copy_smem_launch(const plan::Plan* p, const void* x, void* out, long long rows,
                                long long cols, int tile_rows, int tile_cols, int vec,
                                void* stream) {
  if (rows == 0 || cols == 0) return 0;
  if (tile_rows < 1 || tile_cols < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && (cols % 4 != 0 || tile_cols % 4 != 0)) ||
      p->smem < 2LL * tile_rows * tile_cols * static_cast<long long>(sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  return vec == 4 ? plan::launch(copy_smem_kernel<4>, *p, s, xf, of, rows, cols, tile_rows,
                                 tile_cols)
                  : plan::launch(copy_smem_kernel<1>, *p, s, xf, of, rows, cols, tile_rows,
                                 tile_cols);
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
