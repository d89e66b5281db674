// Cause variants of the per-row Enhanced ERA kernel's multi-pass design,
// built and timed by tools/kernel_variants.py on the card.  Not a kernel of
// the port: the variants without the precise math do not compute Eq. 4.
//
// One block of 256 threads a row, as era_rows_passes in
// src/repro_torch/kernels/csrc/era_rows.cu, over contiguous float32 rows:
// - kPasses = 3: the max pass, the sum pass and the write pass, each
//   reading the row again (era_rows_passes itself when kMath);
// - kPasses = 1: one read and one write a value, with the same count of
//   logs, exps and divisions as three passes (3, 2, 1), on three inputs
//   the compiler cannot merge, and no block reductions;
// - kMath = false: each log becomes a multiply, each exp nothing and the
//   division a multiply, so only the loads, stores and reductions remain.
// Built with the port's flags (-fmad=false, no fast math).
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kEps = 1e-12f;

template <bool kMath>
__device__ __forceinline__ float lb(float x, float beta) {
  return kMath ? logf(x < kEps ? kEps : x) * beta : x * beta;
}

template <bool kMath>
__device__ __forceinline__ float ex(float x) {
  return kMath ? expf(x) : x;
}

template <bool kMath>
__device__ __forceinline__ float divide(float x, float s) {
  return kMath ? x / s : x * s;
}

template <bool kMax>
__device__ float block_reduce(float v, float* part, float* bcast) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : (kMax ? -INFINITY : 0.0f);
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, w, o);
      w = kMax ? fmaxf(w, u) : w + u;
    }
    if (lane == 0) *bcast = w;
  }
  __syncthreads();
  const float r = *bcast;
  __syncthreads();
  return r;
}

template <int kPasses, bool kMath>
__global__ void era_causes(const float* __restrict__ z, float* __restrict__ out, int n,
                           float beta) {
  __shared__ float part[32];
  __shared__ float bcast;
  const float* zr = z + static_cast<long long>(blockIdx.x) * n;
  float* orow = out + static_cast<long long>(blockIdx.x) * n;
  if constexpr (kPasses == 3) {
    float m = -INFINITY;
    for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, lb<kMath>(zr[j], beta));
    m = block_reduce<true>(m, part, &bcast);
    float s = 0.0f;
    for (int j = threadIdx.x; j < n; j += blockDim.x) s += ex<kMath>(lb<kMath>(zr[j], beta) - m);
    s = block_reduce<false>(s, part, &bcast);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      orow[j] = divide<kMath>(ex<kMath>(lb<kMath>(zr[j], beta) - m), s);
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float x = zr[j];
      const float v = lb<kMath>(x, beta);
      const float e = ex<kMath>(lb<kMath>(x * 1.25f, beta) - v);
      orow[j] = divide<kMath>(ex<kMath>(lb<kMath>(x * 1.5f, beta) - v), e + 1.0f);
    }
  }
}

}  // namespace

// z, out: contiguous (rows, n) float32; passes 3 or 1; math 0 or 1.
// Returns the launch's cudaError_t.
extern "C" int era_causes_launch(const void* z, void* out, long long rows, int n, float beta,
                                 int passes, int math, void* stream) {
  const dim3 grid(static_cast<unsigned>(rows)), block(256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  if (passes == 3 && math) era_causes<3, true><<<grid, block, 0, s>>>(zf, of, n, beta);
  else if (passes == 3) era_causes<3, false><<<grid, block, 0, s>>>(zf, of, n, beta);
  else if (math) era_causes<1, true><<<grid, block, 0, s>>>(zf, of, n, beta);
  else era_causes<1, false><<<grid, block, 0, s>>>(zf, of, n, beta);
  return static_cast<int>(cudaGetLastError());
}
