// The counter hash of jax.random's threefry2x32 stream, for sm_90a.
//
// Replaces no Pallas kernel: the reference's jax.random calls (PRNGKey,
// fold_in, split, bits, uniform, normal, permutation, choice) lower to
// XLA's threefry2x32, and repro_torch.core.prng builds all of them on this
// one hash.  For every key i of n_keys and every j < count, with c = start
// + j as a 64-bit count:
//     (y0, y1) = threefry2x32(key_i, (c >> 32, c & 0xFFFFFFFF))
// written as both words (mode 0: split, fold_in), their xor (mode 1:
// random bits) or the xor as a float32 uniform in [0, 1) (mode 2:
// ((y0 ^ y1) >> 9) | 0x3F800000 read as a float, minus 1, exactly).  The
// plain version is repro_torch.core.prng.counter_hash (threefry2x32 on
// int64 tensors masked to 32 bits).
//
// What bounds it on the card: integer issue, then bytes.  A hash is 20
// rounds of an add, a rotate (one funnel shift) and an xor, and five key
// injections of two adds: some 72 integer instructions a value, against 8
// or 16 bytes written (4 for a uniform).  At the FL path's shapes (a leg's
// sort bits over |P| = 10^4 for 300 rounds: 3 * 10^6 values) the two
// bounds are close.  So the kernel does nothing but hash and store: no
// shared memory, no division.  Threads are laid out by powers of two: a
// key takes 2^lanes_log2 consecutive threads of a block (the power of two
// at or above its count, at most the block), the block's other threads the
// next keys, so a split of a million keys (count 2) fills every thread; the
// grid's y axis takes chunks of counts, so one key with 10^4 counts spreads
// over 40 blocks.  Neighbouring threads write neighbouring outputs (16
// bytes a thread for both words), and every index is stepped by shifts,
// masks and adds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "plan.cuh"

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Threefry-2x32, 20 rounds, as jax's _threefry2x32_lowering.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
#define TF_GROUP_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_GROUP_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  TF_GROUP_A
  x0 += k1;
  x1 += k2 + 1u;
  TF_GROUP_B
  x0 += k2;
  x1 += k0 + 2u;
  TF_GROUP_A
  x0 += k0;
  x1 += k1 + 3u;
  TF_GROUP_B
  x0 += k1;
  x1 += k2 + 4u;
  TF_GROUP_A
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_GROUP_B
#undef TF_GROUP_A
#undef TF_ROUND
}

// keys: (n_keys, 2) int64 holding uint32 words.  out: (n_keys, count, 2)
// int64 (MODE 0), (n_keys, count) int64 (MODE 1) or float32 (MODE 2).
template <int MODE>
__global__ void __launch_bounds__(256) threefry_kernel(const long long* __restrict__ keys,
                                                       void* __restrict__ out, long long n_keys,
                                                       long long count,
                                                       unsigned long long start,
                                                       int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int per_block = blockDim.x >> lanes_log2;  // keys a block holds at once
  const int lane = threadIdx.x & (lanes - 1);
  const long long key_step = static_cast<long long>(gridDim.x) * per_block;
  const long long count_step = static_cast<long long>(gridDim.y) * lanes;
  for (long long k = static_cast<long long>(blockIdx.x) * per_block + (threadIdx.x >> lanes_log2);
       k < n_keys; k += key_step) {
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * k]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * k + 1]);
    const long long row = k * count;
    for (long long j = static_cast<long long>(blockIdx.y) * lanes + lane; j < count;
         j += count_step) {
      const unsigned long long c = start + static_cast<unsigned long long>(j);
      uint32_t x0 = static_cast<uint32_t>(c >> 32);
      uint32_t x1 = static_cast<uint32_t>(c);
      threefry2x32(k0, k1, x0, x1);
      if constexpr (MODE == 0) {
        reinterpret_cast<longlong2*>(out)[row + j] =
            make_longlong2(static_cast<long long>(x0), static_cast<long long>(x1));
      } else if constexpr (MODE == 1) {
        static_cast<long long*>(out)[row + j] = static_cast<long long>(x0 ^ x1);
      } else {
        static_cast<float*>(out)[row + j] = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
      }
    }
  }
}

const plan::Kernel kKernels[] = {
    {"threefry_kernel<0>", reinterpret_cast<const void*>(&threefry_kernel<0>)},
    {"threefry_kernel<1>", reinterpret_cast<const void*>(&threefry_kernel<1>)},
    {"threefry_kernel<2>", reinterpret_cast<const void*>(&threefry_kernel<2>)}};

}  // namespace

PLAN_KERNEL_TABLE(threefry, kKernels)

// keys: contiguous (n_keys, 2) int64; out as the kernel's MODE says;
// lanes_log2 as prng_kernel.layout computes it.  Refuses an unknown mode
// and a block that is not whole groups of lanes.
extern "C" int threefry_launch(const plan::Plan* p, const void* keys, void* out,
                               long long n_keys, long long count, unsigned long long start,
                               int mode, int lanes_log2, void* stream) {
  if (n_keys == 0 || count == 0) return 0;
  if (lanes_log2 < 0 || lanes_log2 > 10 || plan::threads(*p) % (1LL << lanes_log2) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  switch (mode) {
    case 0:
      return plan::launch(threefry_kernel<0>, *p, s, k, out, n_keys, count, start, lanes_log2);
    case 1:
      return plan::launch(threefry_kernel<1>, *p, s, k, out, n_keys, count, start, lanes_log2);
    case 2:
      return plan::launch(threefry_kernel<2>, *p, s, k, out, n_keys, count, start, lanes_log2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
