// Per-row soft-target cross entropy (the distillation loss) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/distill_kernel.py::_distill_kernel
// (wrapper distill_loss, pallas_call at distill_kernel.py:88):
//     (B, V) logits l and teacher t, each float32 or bfloat16 -> (B,) float32
//     loss = (m + log(s)) * sum(t) - sum(t * l)
// where m and s are an online max of l and the sum of exp(l - m), rescaled
// whenever m grows, all in float32 in one pass over the row.
//
// What bounds it on the card: bytes.  It reads B*V logits and B*V teacher
// values once and writes B floats; per value pair it does a compare, an
// exp, a multiply-add for s and one for t*l and an add for sum(t), far below
// the H100's flop/byte ridge.  The TPU kernel swept vocab blocks of 2048
// lanes in order, carrying (m, s, sum t*l, sum t) in VMEM scratch from one
// grid step to the next, and padded V with logits of -1e30 and teacher
// weights of 0.  Here one block owns one row: each thread walks the row
// with stride blockDim, keeping its own four accumulators in registers (one
// exp per value: the new value's, or the rescale of s when the max grows),
// and the loop bound replaces the padding.  The threads' partials are then
// combined as (m, s) pairs, s1 * exp(m1 - m) + s2 * exp(m2 - m) with
// m = max(m1, m2), by an xor-shuffle butterfly in each warp and warp 0 over
// the warps' partials in warp order: a fixed tree, so the result does not
// depend on timing.  The running max starts at -1e30, as the TPU kernel's,
// so a thread with no values contributes (m, s) = (-1e30, 0) and no NaN.
//
// Simple first version: scalar loads; V < blockDim leaves threads idle.
//
// Built with -fmad=false (no FMA contraction) and without fast math:
// logf/expf are the precise library versions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "plan.cuh"

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Acc {
  float m, s, dot, tsum;
};

__device__ __forceinline__ Acc combine(const Acc& a, const Acc& b) {
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m), a.dot + b.dot, a.tsum + b.tsum};
}

// Every lane ends with the same value: at each step two lanes combine the
// same two partials, and combine(a, b) == combine(b, a) bit for bit.
__device__ __forceinline__ Acc warp_combine(Acc a) {
  for (int o = 16; o > 0; o >>= 1) {
    const Acc b = {__shfl_xor_sync(0xffffffffu, a.m, o), __shfl_xor_sync(0xffffffffu, a.s, o),
                   __shfl_xor_sync(0xffffffffu, a.dot, o),
                   __shfl_xor_sync(0xffffffffu, a.tsum, o)};
    a = combine(a, b);
  }
  return a;
}

template <typename TL, typename TT>
__global__ void distill_kernel(const TL* __restrict__ logits, const TT* __restrict__ teacher,
                               float* __restrict__ out, int v) {
  __shared__ Acc part[32];
  const long long row = blockIdx.x;
  const TL* lr = logits + row * v;
  const TT* tr = teacher + row * v;
  Acc a = {kNeg, 0.0f, 0.0f, 0.0f};
  for (int j = threadIdx.x; j < v; j += blockDim.x) {
    const float x = to_f32(lr[j]);
    const float w = to_f32(tr[j]);
    if (x > a.m) {
      a.s = a.s * expf(a.m - x) + 1.0f;
      a.m = x;
    } else {
      a.s += expf(x - a.m);
    }
    a.dot += w * x;
    a.tsum += w;
  }
  a = warp_combine(a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    Acc b = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : Acc{kNeg, 0.0f, 0.0f, 0.0f};
    b = warp_combine(b);
    if (lane == 0) out[row] = (b.m + logf(b.s)) * b.tsum - b.dot;
  }
}

template <typename TL, typename TT>
int launch(const plan::Plan& p, const void* l, const void* t, void* out, int v,
           cudaStream_t stream) {
  return plan::launch(distill_kernel<TL, TT>, p, stream, static_cast<const TL*>(l),
                      static_cast<const TT*>(t), static_cast<float*>(out), v);
}

const plan::Kernel kKernels[] = {
    {"distill_kernel<float,float>", reinterpret_cast<const void*>(&distill_kernel<float, float>)},
    {"distill_kernel<float,bf16>",
     reinterpret_cast<const void*>(&distill_kernel<float, __nv_bfloat16>)},
    {"distill_kernel<bf16,float>",
     reinterpret_cast<const void*>(&distill_kernel<__nv_bfloat16, float>)},
    {"distill_kernel<bf16,bf16>",
     reinterpret_cast<const void*>(&distill_kernel<__nv_bfloat16, __nv_bfloat16>)}};

}  // namespace

PLAN_KERNEL_TABLE(distill, kKernels)

// logits, teacher: contiguous (rows, v); dtype codes 0 float32, 1 bfloat16,
// each on its own.  out: (rows,) float32.  One block a row, the plan's grid
// covering the rows (distill_kernel.launch_plan).  Refuses a block that is
// not whole warps.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int distill_launch(const plan::Plan* p, const void* logits, const void* teacher,
                              void* out, int l_dtype, int t_dtype, long long rows, int v,
                              void* stream) {
  if (rows == 0) return 0;
  const long long threads = plan::threads(*p);
  if (threads <= 0 || threads % 32 != 0 || p->block[1] != 1 || p->block[2] != 1 || v <= 0 ||
      l_dtype < 0 || l_dtype > 1 || t_dtype < 0 || t_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (l_dtype * 2 + t_dtype) {
    case 0: return launch<float, float>(*p, logits, teacher, out, v, s);
    case 1: return launch<float, __nv_bfloat16>(*p, logits, teacher, out, v, s);
    case 2: return launch<__nv_bfloat16, float>(*p, logits, teacher, out, v, s);
    case 3: return launch<__nv_bfloat16, __nv_bfloat16>(*p, logits, teacher, out, v, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
