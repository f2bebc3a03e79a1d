// Per-port load and nonzero-count statistics of demand matrices.
//
// Replaces the Pallas TPU kernel `port_stats_pallas`
// (src/repro/kernels/port_stats/kernel.py), which sums f32 copies of the
// demands.  The reference's main path packs its LP from host f64 sums
// (`repro.core.coflow.port_stats`, cast to f32 by `pack_lp_arrays`), so this
// kernel reads the f64 demands and sums in f64 in exactly NumPy's order:
//   * row sums (ingress ports) in NumPy's pairwise order for a contiguous
//     axis -- a plain loop below 8 terms, eight interleaved partial sums
//     combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) up to 128 terms, and
//     one split in two halves above that (this kernel takes n <= 168);
//   * column sums (egress ports) as one running sum down the column.
// The sums are therefore bit-identical to the host NumPy values in f64,
// and so after any cast.
//
// What bounds it on an H100: bytes.  It reads each demand once (8*N*N
// bytes per matrix) and writes 12*2N bytes; at 3200 matrices of 10 x 10
// that is about 3.3 MB, a microsecond of HBM time, so in practice the
// launch dominates.  One block per matrix stages the matrix in shared
// memory with coalesced loads; one thread per port then sums its row or
// column from shared memory.

#include <cuda_runtime.h>

namespace {

// NumPy's pairwise block (n <= 128) over a[0], a[stride], ...
__device__ double pairwise_block(const double* a, int n, int stride) {
  if (n < 8) {
    double res = 0.0;
    for (int i = 0; i < n; ++i) res += a[i * stride];
    return res;
  }
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = a[j * stride];
  int i = 8;
  for (; i < n - (n % 8); i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += a[(i + j) * stride];
  }
  double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res += a[i * stride];
  return res;
}

__device__ double pairwise_sum(const double* a, int n, int stride) {
  if (n <= 128) return pairwise_block(a, n, stride);
  int n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_block(a, n2, stride) +
         pairwise_block(a + n2 * stride, n - n2, stride);
}

__global__ void port_stats_kernel(const double* __restrict__ demands,
                                  double* __restrict__ rho,
                                  int* __restrict__ tau, int n) {
  extern __shared__ double d[];
  const int nn = n * n;
  const size_t m = blockIdx.x;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) d[e] = demands[m * nn + e];
  __syncthreads();

  for (int p = threadIdx.x; p < 2 * n; p += blockDim.x) {
    double s;
    int count = 0;
    if (p < n) {
      s = pairwise_sum(d + p * n, n, 1);
      for (int j = 0; j < n; ++j) count += d[p * n + j] > 0.0;
    } else {
      const int col = p - n;
      s = 0.0;
      for (int i = 0; i < n; ++i) {
        const double v = d[i * n + col];
        s += v;
        count += v > 0.0;
      }
    }
    rho[m * 2 * n + p] = s;
    tau[m * 2 * n + p] = count;
  }
}

}  // namespace

extern "C" int port_stats(const void* demands, void* rho, void* tau,
                          int matrices, int n, void* stream) {
  const size_t smem = static_cast<size_t>(n) * n * sizeof(double);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        port_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 2 * n < 64 ? 64 : ((2 * n + 31) / 32) * 32;
  port_stats_kernel<<<matrices, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(demands), static_cast<double*>(rho),
      static_cast<int*>(tau), n);
  return static_cast<int>(cudaGetLastError());
}
