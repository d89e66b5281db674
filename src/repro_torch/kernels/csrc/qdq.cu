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
// What bounds it on the card: bytes (two passes over a short row, a few
// flops per value).  One thread per row: the row's n values are read
// twice from L1 and written once.  Rows may be strided (row stride `ld`
// elements, unit class stride), so the cache-delta residual view
// (z - base)[..., :-1] is read in place without a copy; the output is
// contiguous (rows, n).  Neighbouring threads touch neighbouring rows, so
// a warp's loads span 32 * ld * 4 bytes and are only partly coalesced:
// a lane-per-value layout is later work.
//
// Built with -fmad=false, so `q * scale + zmin` is a rounded multiply then
// a rounded add, as in the reference, and never one fused multiply-add.
#include <cuda_runtime.h>
#include <math.h>

#include "plan.cuh"

namespace {

__global__ void qdq_kernel(const float* __restrict__ z, float* __restrict__ out,
                           long long rows, int n, long long ld, float levels) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* zr = z + r * ld;
  float zmin = INFINITY;
  float zmax = -INFINITY;
  for (int j = 0; j < n; ++j) {
    const float v = zr[j];
    zmin = fminf(zmin, v);
    zmax = fmaxf(zmax, v);
  }
  const float scale = fmaxf(zmax - zmin, 1e-9f);
  float* o = out + r * n;
  for (int j = 0; j < n; ++j) {
    float q = rintf((zr[j] - zmin) / scale * levels) / levels;
    q = fminf(fmaxf(q, 0.0f), 1.0f);
    o[j] = q * scale + zmin;
  }
}

const plan::Kernel kKernels[] = {{"qdq_kernel", reinterpret_cast<const void*>(&qdq_kernel)}};

}  // namespace

PLAN_KERNEL_TABLE(qdq, kKernels)

// z: (rows, n) float32 with row stride ld and unit class stride;
// out: contiguous (rows, n); one thread a row, the plan's grid covering
// the rows (quant_kernel.launch_plan).  Returns cudaGetLastError() after
// the launch.
extern "C" int qdq_launch(const plan::Plan* p, const void* z, void* out, long long rows,
                          int n, long long ld, float levels, void* stream) {
  if (rows == 0) return 0;
  return plan::launch(qdq_kernel, *p, static_cast<cudaStream_t>(stream),
                      static_cast<const float*>(z), static_cast<float*>(out), rows, n,
                      ld, levels);
}
