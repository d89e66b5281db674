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
// What bounds it on the card: at the slice shape (K=100, rows=1000, N=10)
// latency and instruction issue, not bytes.  It reads the (K, rows, N)
// stack once, the weights and the base, and writes (rows, N): about 4.08
// MB, 1.22 us at 3.35 TB/s; its arithmetic, some 20 flops per input value,
// is far below the flop/byte ridge, but the precise divisions of the code
// (two a coded value and one a decoded value, each about a dozen
// instructions with its slow-path check) make the (client, row) pairs'
// codec the largest phase.  So the design spreads the work over as many
// threads as there are pairs, makes every load coalesced, and computes
// each pair's code once.
//
// Tile layout (fused_round_tile<N>; round_kernel.launch_plan picks the
// chunk and tile from K and N):
//
// - A block owns a tile of `tile` consecutive output rows.  For each
//   client the tile's tile * N floats are contiguous, so the block stages
//   a chunk of `kc` clients' tiles (a (kc, tile, N) slab) in shared memory
//   with asynchronous copies, consecutive threads on consecutive bytes:
//   16-byte copies where every client's tile starts and ends on a 16-byte
//   boundary (the slice: 80 bytes a client at two rows a tile), else
//   4-byte ones.  The client chunks stream through the slab, so any K
//   fits.  Each client's stretch of the slab is `stride` floats: a
//   multiple of 4 for 16-byte copies, else an odd number, so consecutive
//   clients read their rows from distinct banks.
// - Thread (row r, client c) owns one (client, row) pair: it computes the
//   pair's min-max code once, its implied class and simplex sum once, and
//   its weighted decoded row w[k] * v once, which it writes over the
//   pair's values in the slab.  For N <= 16 the kernel is compiled for
//   that N (fused_round_tile<N>): the pair's row lives in registers and
//   every loop over the classes is unrolled without bounds checks; above,
//   fused_round_tile<0> rewrites the row in place in the slab (N = 130
//   reads the client stream once too).  A 1- to 8-bit code reads
//   rint(...) / levels from a table of i / levels, i = 0..levels, divided
//   once a block the same way: the same quotient without a division a
//   value.
// - The client sum of each of the tile's tile * N outputs: `groups`
//   threads each add the chunk's clients g, g + groups, ... (a fixed
//   subset) in double, in client order; then one thread adds the subsets'
//   sums in order to the output's running sum over the chunks.  Rounded
//   once to float (below).  The order is fixed by K and N alone, never by
//   timing or by which rows a launch holds.
// - A warp a row then sharpens the tile's rows (a lane a class up to 32
//   classes, lanes striding the classes above; max and sum by an
//   xor-shuffle butterfly) and writes them.
//
// Rows layout (fused_round_rows), for N whose slab does not fit a block's
// 48 KB at one row and min(K, 32) clients (N > 331 at K >= 32): one warp
// owns an output row, lane l takes clients l, l+32, ..., applies the codec
// to each client's row read from global memory, and accumulates w[k] * v
// into a register chunk of 16 classes; a butterfly sums the lanes; the
// client stream is read again for each 16-class chunk.  No path of the
// port takes it.
//
// Sums (the client sum, the implied class's residual sum, the simplex and
// sharpening row sums) accumulate in double and round once to float.  A
// float32 sum in any order differs from the exact sum by its own rounding
// error, which grows with the number of terms (about sqrt(N) ulps for a
// 130-class row) and which beta multiplies in the sharpened output; the
// double sums keep the kernel's result within one rounding of the exact
// sums of the same float32 terms, whatever the split, so it differs from
// the reference and from the plain version by their own rounding only.
// Every product, quotient, log and exp is still float32, as there.
//
// Built with -fmad=false (no FMA contraction: w * v + acc and
// q * scale + min round as two operations, as in the reference) and
// without fast math: logf/expf/division are the precise versions.
#include <cuda_runtime.h>
#include <math.h>

#include "plan.cuh"

namespace {

constexpr int kChunk = 16;         // classes in registers (tile) or a register chunk (rows)
constexpr int kTileThreads = 1024;  // most threads a tile block
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
  int kc;      // tile layout: clients a chunk
  int tile;    // tile layout: rows a block
  int stride;  // tile layout: floats of a client's stretch of the slab
  int vec;     // tile layout: floats a staging copy moves, 4 or 1
  int table;   // tile layout: entries of the q / levels table, or 0
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

// tab, where not null, holds i / levels for i = 0..levels, divided as
// below: the quotient of a code in range is read, not divided again.
__device__ __forceinline__ float qdq(const Args& a, const RowCode& c, float x,
                                     const float* tab) {
  const float t = rintf((x - c.rmin) / c.scale * a.levels);
  float q = tab != nullptr && t >= 0.0f && t <= a.levels ? tab[static_cast<int>(t)]
                                                          : t / a.levels;
  q = fminf(fmaxf(q, 0.0f), 1.0f);
  return q * c.scale + c.rmin;
}

__device__ __forceinline__ float sharpen_log(const Args& a, float zsum) {
  const float zbar = zsum / static_cast<float>(a.k_clients);
  return logf(fmaxf(zbar, 1e-12f)) * a.beta;
}

// Sharpens (or copies, for the linear moment) one row of float sums
// `rs(j)` into orow; called by a whole warp.  Up to 32 classes, lane j
// keeps class j's log in a register; above, each pass recomputes it.
template <typename F>
__device__ void finish_row(const Args& a, F rs, float* orow) {
  const int lane = threadIdx.x & 31;
  if (!a.sharpen) {
    for (int j = lane; j < a.n; j += 32) orow[j] = rs(j);
    return;
  }
  if (a.n <= 32) {
    const float x = lane < a.n ? sharpen_log(a, rs(lane)) : -INFINITY;
    const float m = warp_max(x);
    const float e = lane < a.n ? expf(x - m) : 0.0f;
    const float s = static_cast<float>(warp_sum(static_cast<double>(e)));
    if (lane < a.n) orow[lane] = e / s;
    return;
  }
  float m = -INFINITY;
  for (int j = lane; j < a.n; j += 32) m = fmaxf(m, sharpen_log(a, rs(j)));
  m = warp_max(m);
  double sd = 0.0;
  for (int j = lane; j < a.n; j += 32) sd += expf(sharpen_log(a, rs(j)) - m);
  const float s = static_cast<float>(warp_sum(sd));
  for (int j = lane; j < a.n; j += 32) orow[j] = expf(sharpen_log(a, rs(j)) - m) / s;
}

// ---------------------------------------------------------------------------
// Tile layout
// ---------------------------------------------------------------------------

// A pair's row: kN registers (N = kN <= kChunk, a constant of the
// kernel) or, for kN = 0, its stretch of the slab.  Indices of the
// register row are constants after unrolling.
template <int kN>
struct PairRow {
  float v[kN];
  __device__ __forceinline__ float& operator[](int j) { return v[j]; }
};

template <>
struct PairRow<0> {
  float* v;
  __device__ __forceinline__ float& operator[](int j) { return v[j]; }
};

// The classes of a row: the kernel's constant, or n for kN = 0.
template <int kN>
__device__ __forceinline__ int classes(int n) {
  return kN ? kN : n;
}

// On entry x holds the values the code sees (z, or z - b for delta); on
// return the values before simplex re-projection (quant, delta: b + r with
// the implied class), and the pair's code.  b is the row's base.
template <int kN>
__device__ RowCode pair_code(const Args& a, PairRow<kN>& x, const float* b,
                             const float* tab) {
  RowCode c{0.0f, 1.0f, 0.0f, 1.0f};
  if (a.mode == kIdentity) return c;
  const int n = classes<kN>(a.n);
  const int nq = a.mode == kDelta ? n - 1 : n;  // classes on the wire
  if (a.levels != 0.0f) {
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (j < nq) {
        lo = fminf(lo, x[j]);
        hi = fmaxf(hi, x[j]);
      }
    }
    c.rmin = lo;
    c.scale = fmaxf(hi - lo, 1e-9f);
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (j < nq) x[j] = qdq(a, c, x[j], tab);
    }
  }
  if (a.mode == kDelta) {
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (j < nq) s += x[j];
    }
    c.last = -static_cast<float>(s);
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (j < n) x[j] = j < nq ? b[j] + x[j] : b[j] + c.last;
    }
  }
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (j < n) s += fmaxf(x[j], 0.0f);
  }
  c.denom = fmaxf(static_cast<float>(s), 1e-9f);
  return c;
}

__device__ __forceinline__ float decode(const Args& a, const RowCode& c, float x) {
  return a.mode == kIdentity ? x : fmaxf(x, 0.0f) / c.denom;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int kN>
__global__ void __launch_bounds__(kTileThreads) fused_round_tile(Args a) {
  extern __shared__ double smem_d[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int n = classes<kN>(a.n), outs = a.tile * n;  // the tile's output values
  const int groups = max(1, nthr / outs);  // client subsets an output's sum is split into
  double* acc = smem_d;                    // [outs] running client sums
  double* part = acc + outs;               // [groups][outs] the subsets' sums
  float* slab = reinterpret_cast<float*>(  // [kc][stride] clients' tiles, 16-byte aligned
      smem_d + ((outs + groups * outs + 1) & ~1));
  float* sbase = slab + a.kc * a.stride;  // [outs] base tile
  float* tab = sbase + outs;             // [table] i / levels
  const long long row0 = static_cast<long long>(blockIdx.x) * a.tile;
  const int rows_here = static_cast<int>(min(static_cast<long long>(a.tile), a.rows - row0));
  const int len = rows_here * n;  // a client's contiguous floats in the tile
  const long long plane = a.rows * static_cast<long long>(n);
  const int r = tid / a.kc, c = tid - r * a.kc;  // this thread's pair: row r, client c

  for (int i = tid; i < outs; i += nthr) acc[i] = 0.0;
  if (a.mode == kDelta) {
    for (int i = tid; i < len; i += nthr) sbase[i] = a.base[row0 * n + i];
  }
  for (int i = tid; i < a.table; i += nthr) tab[i] = static_cast<float>(i) / a.levels;
  const float* b = sbase + r * n;

  for (int k0 = 0; k0 < a.k_clients; k0 += a.kc) {
    const int nk = min(a.kc, a.k_clients - k0);
    const float* zc = a.z + static_cast<long long>(k0) * plane + row0 * n;
    if (a.vec == 4) {  // 16-byte copies: the plan found every client's tile aligned
      const int nv = len >> 2;
      for (int t = tid; t < nk * nv; t += nthr) {
        const int kk = t / nv, v = t - kk * nv;
        cp_async16(slab + kk * a.stride + 4 * v, zc + kk * plane + 4 * v);
      }
    } else {
      for (int kk = warp; kk < nk; kk += nwarps) {
        for (int i = lane; i < len; i += 32) {
          cp_async4(slab + kk * a.stride + i, zc + kk * plane + i);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // the pair's weighted decoded row, written over its values in the slab
    if (r < rows_here && c < nk) {
      float* xs = slab + c * a.stride + r * n;
      PairRow<kN> x;
      if constexpr (kN == 0) x.v = xs;
#pragma unroll
      for (int j = 0; j < n; ++j) {
        if (j < n) x[j] = a.mode == kDelta ? xs[j] - b[j] : xs[j];
      }
      const RowCode code = pair_code<kN>(a, x, b, a.table ? tab : nullptr);
      const float wk = a.w[k0 + c];
#pragma unroll
      for (int j = 0; j < n; ++j) {
        // the float32 product, as in the reference, summed in double below
        if (j < n) xs[j] = wk * decode(a, code, x[j]);
      }
    }
    __syncthreads();
    // output o's sum over the chunk: thread (g, o) adds clients g, g + groups, ...
    for (int t = tid; t < groups * outs; t += nthr) {
      const int g = t / outs, o = t - g * outs;
      double s = 0.0;
      if (o < len) {
#pragma unroll 4
        for (int cc = g; cc < nk; cc += groups) s += slab[cc * a.stride + o];
      }
      part[t] = s;
    }
    __syncthreads();
    for (int o = tid; o < len; o += nthr) {
      double s = acc[o];
      for (int g = 0; g < groups; ++g) s += part[g * outs + o];
      acc[o] = s;
    }
    __syncthreads();  // acc is complete, part and the slab free again
  }

  for (int rr = warp; rr < rows_here; rr += nwarps) {
    const double* ar = acc + rr * n;
    finish_row(a, [ar](int j) { return static_cast<float>(ar[j]); }, a.out + (row0 + rr) * n);
  }
}

// ---------------------------------------------------------------------------
// Rows layout: a warp a row, clients read from global memory
// ---------------------------------------------------------------------------

// The value the min-max code sees at class j: z, or the residual z - b.
__device__ __forceinline__ float raw(const Args& a, const float* zr, const float* br, int j) {
  return a.mode == kDelta ? zr[j] - br[j] : zr[j];
}

__device__ __forceinline__ float coded(const Args& a, const RowCode& c, const float* zr,
                                       const float* br, int j) {
  const float x = raw(a, zr, br, j);
  return a.levels == 0.0f ? x : qdq(a, c, x, nullptr);
}

// The row before simplex re-projection, at class j.
__device__ __forceinline__ float pre_simplex(const Args& a, const RowCode& c, const float* zr,
                                             const float* br, int j) {
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

__device__ __forceinline__ float decoded(const Args& a, const RowCode& c, const float* zr,
                                         const float* br, int j) {
  if (a.mode == kIdentity) return zr[j];
  return fmaxf(pre_simplex(a, c, zr, br, j), 0.0f) / c.denom;
}

__global__ void fused_round_rows(Args a) {
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
        if (c0 + j < a.n) acc[j] += wk * decoded(a, c, zr, br, c0 + j);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const double s = warp_sum(acc[j]);
      if (lane == j && c0 + j < a.n) orow[c0 + j] = static_cast<float>(s);
    }
  }
  __syncwarp();  // the row sums written above are visible to every lane
  // each lane rewrites only the classes it reads
  finish_row(a, [orow](int j) { return orow[j]; }, orow);
}

#define TILE(N) {"fused_round_tile<" #N ">", reinterpret_cast<const void*>(&fused_round_tile<N>)}

const plan::Kernel kKernels[] = {
    TILE(1), TILE(2), TILE(3), TILE(4), TILE(5), TILE(6), TILE(7), TILE(8), TILE(9), TILE(10),
    TILE(11), TILE(12), TILE(13), TILE(14), TILE(15), TILE(16),
    {"fused_round_tile<smem>", reinterpret_cast<const void*>(&fused_round_tile<0>)},
    {"fused_round_rows", reinterpret_cast<const void*>(&fused_round_rows)}};

#undef TILE

}  // namespace

PLAN_KERNEL_TABLE(fused_round, kKernels)

// z: contiguous (k_clients, rows, n) float32; w: (k_clients,); base:
// contiguous (rows, n) for mode 2 (delta), else null; out: contiguous
// (rows, n).  mode: 0 identity, 1 quant, 2 delta; levels: 2^bits - 1 or 0
// for no min-max code.  layout 0: the tile layout, `tile` rows a block,
// `kc` clients a chunk (the plan's block is tile * kc threads rounded up
// to whole warps, and its shared memory holds the sums and the slab of
// `stride` floats a client), with the class row in registers when n <= 16;
// layout 1: a warp a row, block / 32 rows a block.  The plan's grid covers
// the rows (round_kernel.launch_plan).  Refuses a block that is not whole
// warps and a tile the block does not match.  Returns the launch's
// cudaError_t.
extern "C" int fused_round_launch(const plan::Plan* p, const void* z, const void* w,
                                  const void* base, void* out, int k_clients,
                                  long long rows, int n, int mode, float levels,
                                  int sharpen, float beta, int layout, int kc, int tile,
                                  int stride, int vec, int table, void* stream) {
  if (rows == 0) return 0;
  const long long threads = plan::threads(*p);
  if (threads <= 0 || threads % 32 != 0 || p->block[1] != 1 || p->block[2] != 1 ||
      layout < 0 || layout > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layout == 0 && (kc <= 0 || tile <= 0 || static_cast<long long>(kc) * tile > threads ||
                      threads - static_cast<long long>(kc) * tile >= 32 || stride < tile * n ||
                      (vec != 1 && vec != 4) || (vec == 4 && stride % 4 != 0) || table < 0 ||
                      (table > 0 && table != static_cast<int>(levels) + 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const float*>(z), static_cast<const float*>(w),
         static_cast<const float*>(base), static_cast<float*>(out),
         k_clients, rows, n, mode, levels, sharpen, beta, kc, tile, stride, vec, table};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 1) return plan::launch(fused_round_rows, *p, s, a);
  switch (n) {
#define TILE(N) \
  case N: return plan::launch(fused_round_tile<N>, *p, s, a);
    TILE(1) TILE(2) TILE(3) TILE(4) TILE(5) TILE(6) TILE(7) TILE(8) TILE(9) TILE(10)
    TILE(11) TILE(12) TILE(13) TILE(14) TILE(15) TILE(16)
#undef TILE
    default: return plan::launch(fused_round_tile<0>, *p, s, a);
  }
}
