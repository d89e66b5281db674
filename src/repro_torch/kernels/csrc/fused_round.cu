// The fused SCARLET round for sm_90a: uplink codec round trip, weighted
// client sum and Enhanced-ERA sharpening in one pass.
//
// Replaces the TPU kernel src/repro/kernels/round_kernel.py::_fused_round_kernel
// (wrapper fused_round, pallas_call at round_kernel.py:205):
//     (K, rows, N) client soft-labels, (K,) weights, optional (rows, N)
//     delta base, runtime beta -> (rows, N)
// Per row, for each client k, the codec round trip of z[k, row, :]:
//     identity:  v = z
//     quant:     v = simplex(qdq(z))                      over the N classes
//     delta:     r = z - b;  r[:N-1] = qdq(r[:N-1]) if bits;
//                r[N-1] = -sum(r[:N-1]);  v = simplex(b + r)
// with qdq(x) = clamp(rint((x - min) / max(max - min, 1e-9) * L) / L, 0, 1)
//               * scale + min,  L = 2^bits - 1   (as qdq.cu)
// and  simplex(y) = max(y, 0) / max(sum(max(y, 0)), 1e-9);
// then zsum = sum_k w[k] * v (product, then add);
// then, if sharpen:  zbar = zsum / K;  x = log(max(zbar, 1e-12)) * beta;
//                    out = exp(x - rowmax(x)) / rowsum(exp(x - rowmax(x)))
// in exactly that order (as era_fused.cu), else out = zsum.
//
// What bounds it on the card: bytes.  It reads the (K, rows, N) stack once
// (4.0 MB at the slice shape K=100, rows=1000, N=10), the weights and the
// base, and writes (rows, N): about 4.08 MB, 1.22 us at 3.35 TB/s.  Its
// arithmetic, some 20 flops per input value, is far below the flop/byte
// ridge.
//
// Design.  The TPU kernel held a (K, bm, 128) block in VMEM so the client
// sum finished inside the block.  Here one warp owns one output row and
// streams the client axis instead: lane l takes clients l, l+32, ...,
// applies the codec to each client's row in registers (the row's min,
// max and simplex sum are short sequential loops over N, re-read from
// L1), and accumulates w[k] * v into a register chunk of kChunk classes.
// A fixed xor-shuffle butterfly then sums the 32 lanes' partials; every
// lane ends with the same bits, and the result depends on neither the row
// blocking nor the launch.  The row sum is written to `out`, and the warp
// sharpens it there in place (lanes stride the classes; max and sum by
// the same butterfly).  Rows are independent, so blocks need no
// cooperation and the kernel allocates nothing.  For N > kChunk the
// client stream is repeated once per chunk of classes.
//
// Sums (the client sum, the implied class's residual sum, the simplex and
// sharpening row sums) accumulate in double and round once to float.  A
// float32 sum in any order differs from the exact sum by its own rounding
// error, which grows with the number of terms (about sqrt(N) ulps for a
// 130-class row) and which beta multiplies in the sharpened output; the
// double sums keep the kernel's result within one rounding of the exact
// sums of the same float32 terms, whatever the lane split, so it differs
// from the reference and from the plain version by their own rounding
// only.  Every product, quotient, log and exp is still float32, as there.
//
// Simple first version: 1000 rows give 1000 warps, about 7.6 per SM, and
// each lane's loads of a 40-byte client row are 40 KB apart from its
// neighbours', so the kernel is latency bound well above the byte bound.
//
// Built with -fmad=false (no FMA contraction: w * v + acc and
// q * scale + min round as two operations, as in the reference) and
// without fast math: logf/expf/division are the precise versions.
#include <cuda_runtime.h>
#include <math.h>

#include "plan.cuh"

namespace {

constexpr int kChunk = 16;   // classes accumulated in registers per pass
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kIdentity = 0, kQuant = 1, kDelta = 2 };

struct Args {
  const float* z;
  const float* w;
  const float* base;
  float* out;
  int k_clients;
  long long rows;
  int n;
  int mode;
  float levels;  // 2^bits - 1, or 0 for no min-max code
  int sharpen;
  float beta;
};

// Per (client, row): the min-max code's offset and scale, the implied
// last residual class (delta) and the simplex denominator.
struct RowCode {
  float rmin, scale, last, denom;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The value the min-max code sees at class j: z, or the residual z - b.
__device__ __forceinline__ float raw(const Args& a, const float* zr,
                                     const float* br, int j) {
  return a.mode == kDelta ? zr[j] - br[j] : zr[j];
}

__device__ __forceinline__ float coded(const Args& a, const RowCode& c,
                                       const float* zr, const float* br,
                                       int j) {
  const float x = raw(a, zr, br, j);
  if (a.levels == 0.0f) return x;
  float q = rintf((x - c.rmin) / c.scale * a.levels) / a.levels;
  q = fminf(fmaxf(q, 0.0f), 1.0f);
  return q * c.scale + c.rmin;
}

// The row before simplex re-projection, at class j.
__device__ __forceinline__ float pre_simplex(const Args& a, const RowCode& c,
                                             const float* zr, const float* br,
                                             int j) {
  if (a.mode == kQuant) return coded(a, c, zr, br, j);
  return j < a.n - 1 ? br[j] + coded(a, c, zr, br, j) : br[j] + c.last;
}

__device__ RowCode row_code(const Args& a, const float* zr, const float* br) {
  RowCode c{0.0f, 1.0f, 0.0f, 1.0f};
  if (a.mode == kIdentity) return c;
  const int nq = a.mode == kDelta ? a.n - 1 : a.n;  // classes on the wire
  if (a.levels != 0.0f) {
    float lo = INFINITY, hi = -INFINITY;
    for (int j = 0; j < nq; ++j) {
      const float x = raw(a, zr, br, j);
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
    c.rmin = lo;
    c.scale = fmaxf(hi - lo, 1e-9f);
  }
  if (a.mode == kDelta) {
    double s = 0.0;
    for (int j = 0; j < nq; ++j) s += coded(a, c, zr, br, j);
    c.last = -static_cast<float>(s);
  }
  double s = 0.0;
  for (int j = 0; j < a.n; ++j) s += fmaxf(pre_simplex(a, c, zr, br, j), 0.0f);
  c.denom = fmaxf(static_cast<float>(s), 1e-9f);
  return c;
}

__device__ __forceinline__ float decoded(const Args& a, const RowCode& c,
                                         const float* zr, const float* br,
                                         int j) {
  if (a.mode == kIdentity) return zr[j];
  return fmaxf(pre_simplex(a, c, zr, br, j), 0.0f) / c.denom;
}

__device__ __forceinline__ float sharpen_log(const Args& a, float zsum) {
  const float zbar = zsum / static_cast<float>(a.k_clients);
  return logf(fmaxf(zbar, 1e-12f)) * a.beta;
}

__global__ void fused_round_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // the whole warp leaves together
  const long long plane = a.rows * static_cast<long long>(a.n);
  const float* br = a.base != nullptr ? a.base + row * a.n : nullptr;
  float* orow = a.out + row * a.n;

  for (int c0 = 0; c0 < a.n; c0 += kChunk) {
    double acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.0;
    for (int k = lane; k < a.k_clients; k += 32) {
      const float* zr = a.z + static_cast<long long>(k) * plane + row * a.n;
      const RowCode c = row_code(a, zr, br);
      const float wk = a.w[k];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        // the float32 product, as in the reference, summed in double
        if (c0 + j < a.n) acc[j] += wk * decoded(a, c, zr, br, c0 + j);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const double s = warp_sum(acc[j]);
      if (lane == j && c0 + j < a.n) orow[c0 + j] = static_cast<float>(s);
    }
  }
  if (!a.sharpen) return;
  __syncwarp();  // the row sums written above are visible to every lane

  float m = -INFINITY;
  for (int j = lane; j < a.n; j += 32) m = fmaxf(m, sharpen_log(a, orow[j]));
  m = warp_max(m);
  double sd = 0.0;
  for (int j = lane; j < a.n; j += 32) sd += expf(sharpen_log(a, orow[j]) - m);
  const float s = static_cast<float>(warp_sum(sd));
  // each lane rewrites only the classes it read
  for (int j = lane; j < a.n; j += 32) {
    orow[j] = expf(sharpen_log(a, orow[j]) - m) / s;
  }
}

const plan::Kernel kKernels[] = {
    {"fused_round_kernel", reinterpret_cast<const void*>(&fused_round_kernel)}};

}  // namespace

PLAN_KERNEL_TABLE(fused_round, kKernels)

// z: contiguous (k_clients, rows, n) float32; w: (k_clients,); base:
// contiguous (rows, n) for mode 2 (delta), else null; out: contiguous
// (rows, n).  mode: 0 identity, 1 quant, 2 delta; levels: 2^bits - 1 or 0
// for no min-max code.  A warp a row, block / 32 rows a block, the plan's
// grid covering the rows (round_kernel.launch_plan).  Refuses a block that
// is not whole warps.  Returns cudaGetLastError() after the launch.
extern "C" int fused_round_launch(const plan::Plan* p, const void* z, const void* w,
                                  const void* base, void* out, int k_clients,
                                  long long rows, int n, int mode,
                                  float levels, int sharpen, float beta,
                                  void* stream) {
  if (rows == 0) return 0;
  const long long threads = plan::threads(*p);
  if (threads <= 0 || threads % 32 != 0 || p->block[1] != 1 || p->block[2] != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const float*>(z), static_cast<const float*>(w),
         static_cast<const float*>(base), static_cast<float*>(out),
         k_clients, rows, n, mode, levels, sharpen, beta};
  return plan::launch(fused_round_kernel, *p, static_cast<cudaStream_t>(stream), a);
}
