// Host-side launch as thread block clusters, shared by the C entries of
// `pair_resolve` and `event_resolve`.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Launches `grid` blocks of `threads` in clusters of `cluster` consecutive
// blocks (`grid` a multiple of `cluster`).  Returns the launch's error,
// else `cudaGetLastError()`: a refused cluster shape never runs.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), unsigned grid,
                                   unsigned threads, size_t smem, unsigned cluster,
                                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace repro
