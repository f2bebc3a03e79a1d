// Pair-space resolution round of the batched circuit calendar.
//
// Replaces the Pallas TPU kernel `pair_resolve_pallas`
// (src/repro/kernels/event_resolve/kernel.py).  For each member g of the
// (instance, core) batch, claim[g] is the N x N matrix of claiming head flow
// ids (int32; any value >= the member's flow count means "no claim") and
// idle[g] whether the pair may start now.  A pair starts iff it is idle and
// its claim is the minimum of its row (first claimer on the ingress port)
// and of its column (first claimer on the egress port).
//
// What bounds it on an H100: nothing the card offers.  One round reads
// G*N*N*5 bytes and writes G*N*N bytes (about 17 KB at the paper's G = 96,
// N = 12) -- microseconds of bandwidth -- so its time is the launch and
// the block's two barriers.  The design keeps it to one launch per round:
// one block per member, the claim matrix staged once in shared memory, a
// row-min pass and a column-min pass by one thread per row/column, then
// the start mask.  The TPU kernel carried ids as exact f32; here they stay
// int32, so ids are exact up to 2**31 - 1 and no f32 guard is needed.
// Above the default 48 KB of dynamic shared memory (N > 100) the first
// launch on a device raises the kernel's limit to the device's opt-in
// maximum, 227 KB on Hopper: (N*N + 2N) int32 fit for N <= 240.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace {

__global__ void pair_resolve_kernel(const int* __restrict__ claim,
                                    const bool* __restrict__ idle,
                                    bool* __restrict__ start, int n) {
  extern __shared__ int smem[];
  const int nn = n * n;
  int* c = smem;            // (n, n) claims of this member
  int* rowmin = smem + nn;  // (n,)
  int* colmin = rowmin + n; // (n,)
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;

  for (int e = threadIdx.x; e < nn; e += blockDim.x) c[e] = claim[base + e];
  __syncthreads();

  for (int r = threadIdx.x; r < 2 * n; r += blockDim.x) {
    int m = INT_MAX;
    if (r < n) {
      for (int j = 0; j < n; ++j) m = min(m, c[r * n + j]);
      rowmin[r] = m;
    } else {
      const int col = r - n;
      for (int i = 0; i < n; ++i) m = min(m, c[i * n + col]);
      colmin[col] = m;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int v = c[e];
    start[base + e] = idle[base + e] && v == rowmin[e / n] && v == colmin[e % n];
  }
}

constexpr int kMaxDevices = 16;

}  // namespace

extern "C" int pair_resolve(const void* claim, const void* idle, void* start,
                            int members, int n, void* stream) {
  const int threads = 128;
  const size_t smem = static_cast<size_t>(n * n + 2 * n) * sizeof(int);
  if (smem > 48 * 1024) {
    // Raise the kernel's opt-in limit to the device's maximum once per
    // device: the attribute persists in the context, so later launches
    // skip the host call, and it is never lowered.
    static std::atomic<bool> raised[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || !raised[dev].load()) {
      int optin = 0;
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaFuncSetAttribute(
          pair_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) raised[dev].store(true);
    }
  }
  pair_resolve_kernel<<<members, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(claim), static_cast<const bool*>(idle),
      static_cast<bool*>(start), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
