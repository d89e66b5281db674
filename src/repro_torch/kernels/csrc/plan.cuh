// The launch plan every kernel library of the port takes, and the table of
// kernels it exports for reading their compiled attributes.
//
// A wrapper computes its launch in Python (repro_torch.kernels.runtime.
// LaunchPlan: grid, block, thread-block cluster, dynamic shared memory and
// whether the kernel opts in above 48 KB) and hands it to the library's C
// launcher as a `Plan`; no launcher derives a grid, a block, a cluster or a
// shared-memory size of its own, so the static lint
// (repro_torch.analysis.launch_checks) sees exactly what the card
// launches.  A launcher refuses only a plan its kernel cannot run at all.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace plan {

// Field for field runtime._CPlan.
struct Plan {
  long long grid[3];
  long long block[3];
  long long smem;        // dynamic shared memory, bytes
  long long smem_optin;  // nonzero: raise the kernel's dynamic limit to smem first
  long long cluster[3];  // blocks a cluster; (1, 1, 1): no cluster
};

// The plan's grid and block as dim3, or false when a dimension is below 1
// or past what a dim3 holds (the card refuses the rest of what is past its
// limits at launch).
inline bool dims(const Plan& p, dim3* grid, dim3* block) {
  for (int i = 0; i < 3; ++i) {
    if (p.grid[i] < 1 || p.grid[i] > UINT_MAX) return false;
    if (p.block[i] < 1 || p.block[i] > UINT_MAX) return false;
  }
  *grid = dim3(static_cast<unsigned>(p.grid[0]), static_cast<unsigned>(p.grid[1]),
               static_cast<unsigned>(p.grid[2]));
  *block = dim3(static_cast<unsigned>(p.block[0]), static_cast<unsigned>(p.block[1]),
                static_cast<unsigned>(p.block[2]));
  return p.smem >= 0 && p.smem <= INT_MAX;
}

inline long long threads(const Plan& p) { return p.block[0] * p.block[1] * p.block[2]; }

inline long long cluster_blocks(const Plan& p) {
  return p.cluster[0] * p.cluster[1] * p.cluster[2];
}

// Launches kernel `fn` with the plan on `stream`: the opt-in first where
// the plan asks for it, then the launch, through cudaLaunchKernelEx with
// the cluster dimension where the plan has clusters of more than one
// block.  Returns the cudaError_t of the opt-in if it failed (the launch
// is then not made), else that of the launch.
template <typename... P, typename... A>
int launch(void (*fn)(P...), const Plan& p, cudaStream_t stream, A... args) {
  dim3 grid, block;
  if (!dims(p, &grid, &block)) return static_cast<int>(cudaErrorInvalidConfiguration);
  for (int i = 0; i < 3; ++i) {
    if (p.cluster[i] < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  }
  if (cluster_blocks(p) > 8) return static_cast<int>(cudaErrorInvalidClusterSize);
  if (p.smem_optin) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // the refusal is returned, not left for the next launch
      return static_cast<int>(e);
    }
  }
  if (cluster_blocks(p) == 1) {
    fn<<<grid, block, static_cast<size_t>(p.smem), stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster[0]);
  attr[0].val.clusterDim.y = static_cast<unsigned>(p.cluster[1]);
  attr[0].val.clusterDim.z = static_cast<unsigned>(p.cluster[2]);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, static_cast<P>(args)...);
  if (e != cudaSuccess) {
    cudaGetLastError();  // returned here, not left for the next launch
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

struct Kernel {
  const char* name;  // as runtime.LaunchPlan.kernel names it
  const void* fn;
};

// cudaFuncAttributes of table[which] into out: numRegs, localSizeBytes,
// sharedSizeBytes, maxThreadsPerBlock.
inline int attrs(const Kernel* table, int n, int which, long long* out) {
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, table[which].fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  out[2] = static_cast<long long>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace plan

// The three functions runtime.kernel_names and runtime.func_attrs read:
// <lib>_kernel_count(), <lib>_kernel_name(i) and <lib>_func_attrs(i, out).
#define PLAN_KERNEL_TABLE(lib, table)                                             \
  extern "C" int lib##_kernel_count() {                                           \
    return static_cast<int>(sizeof(table) / sizeof(table[0]));                    \
  }                                                                               \
  extern "C" const char* lib##_kernel_name(int which) {                           \
    return which >= 0 && which < lib##_kernel_count() ? table[which].name : nullptr; \
  }                                                                               \
  extern "C" int lib##_func_attrs(int which, long long* out) {                    \
    return plan::attrs(table, lib##_kernel_count(), which, out);                  \
  }
