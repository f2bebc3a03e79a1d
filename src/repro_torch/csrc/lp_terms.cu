// Fused hard-max terms of the batched ordering LP.
//
// Replaces the Pallas TPU kernel `lp_terms_batch_pallas`
// (src/repro/kernels/lp_terms/kernel.py).  For every ensemble member b and
// coflow m:
//   t_load[b, m] = max_p (X^T P_rho)[b, m, p] * inv_R[b]
//   t_rec[b, m]  = max_p (X^T P_tau)[b, m, p] * delta_over_K[b]
// with x (B, M, M), p_rho / p_tau (B, M, P), all f32.  Padded ports hold
// zeros and every real load is >= 0, so the unmasked max over the padded
// width equals the reference's -inf-masked max whenever a member has a
// real port; the scale is applied after the max, which rounding keeps
// exact (x -> x * s is monotone for s > 0).
//
// What bounds it on an H100: at the paper's B = 32, M = 104, P = 24 the
// two products are 2 * 2*B*M*M*P = 33 MFLOP against 2.0 MB of inputs --
// about 16 FLOP per byte, below the f32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so bytes bound it in principle (0.6 us); in practice it
// is a few microseconds and launch latency dominates.  The design is one launch
// for the whole ensemble: grid (member, 32-row tile of m), each block
// walking the q axis in 32-deep tiles staged in shared memory (x tile,
// P_rho and P_tau tiles), f32 FMAs on CUDA cores (no TF32, no library),
// and the row max plus the per-member scale fused into the epilogue, so
// the (M, P) products never reach device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 32;       // output rows (m) per block
constexpr int kBK = 32;       // contraction depth (q) per tile
constexpr int kGroups = 8;    // port groups: 256 threads = kBM x kGroups
constexpr int kMaxPPerThread = 16;  // P <= kGroups * kMaxPPerThread = 128

__global__ void lp_terms_batch_kernel(
    const float* __restrict__ x, const float* __restrict__ p_rho,
    const float* __restrict__ p_tau, const float* __restrict__ inv_R,
    const float* __restrict__ delta_over_K, float* __restrict__ t_load,
    float* __restrict__ t_rec, int M, int P) {
  extern __shared__ float smem[];
  float* xs = smem;               // (kBK, kBM)
  float* rs = xs + kBK * kBM;     // (kBK, P)
  float* ts = rs + kBK * P;       // (kBK, P)
  float* red = ts + kBK * P;      // (2, kGroups, kBM) epilogue maxima

  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int tm = threadIdx.x % kBM;
  const int tp = threadIdx.x / kBM;
  const size_t xb = static_cast<size_t>(b) * M * M;
  const size_t pb = static_cast<size_t>(b) * M * P;

  float acc_r[kMaxPPerThread];
  float acc_t[kMaxPPerThread];
#pragma unroll
  for (int u = 0; u < kMaxPPerThread; ++u) {
    acc_r[u] = 0.0f;
    acc_t[u] = 0.0f;
  }

  for (int q0 = 0; q0 < M; q0 += kBK) {
    for (int e = threadIdx.x; e < kBK * kBM; e += blockDim.x) {
      const int kk = e / kBM, mm = e % kBM;
      const int q = q0 + kk, m = m0 + mm;
      xs[e] = (q < M && m < M) ? x[xb + static_cast<size_t>(q) * M + m] : 0.0f;
    }
    for (int e = threadIdx.x; e < kBK * P; e += blockDim.x) {
      const int kk = e / P, p = e % P;
      const int q = q0 + kk;
      const bool in = q < M;
      rs[e] = in ? p_rho[pb + static_cast<size_t>(q) * P + p] : 0.0f;
      ts[e] = in ? p_tau[pb + static_cast<size_t>(q) * P + p] : 0.0f;
    }
    __syncthreads();
    const int depth = min(kBK, M - q0);
    for (int kk = 0; kk < depth; ++kk) {
      const float xv = xs[kk * kBM + tm];
#pragma unroll
      for (int u = 0; u < kMaxPPerThread; ++u) {
        const int p = tp + kGroups * u;
        if (p < P) {
          acc_r[u] = fmaf(xv, rs[kk * P + p], acc_r[u]);
          acc_t[u] = fmaf(xv, ts[kk * P + p], acc_t[u]);
        }
      }
    }
    __syncthreads();
  }

  float mr = -INFINITY, mt = -INFINITY;
#pragma unroll
  for (int u = 0; u < kMaxPPerThread; ++u) {
    if (tp + kGroups * u < P) {
      mr = fmaxf(mr, acc_r[u]);
      mt = fmaxf(mt, acc_t[u]);
    }
  }
  red[tp * kBM + tm] = mr;
  red[(kGroups + tp) * kBM + tm] = mt;
  __syncthreads();
  if (tp == 0 && m0 + tm < M) {
    for (int g = 1; g < kGroups; ++g) {
      mr = fmaxf(mr, red[g * kBM + tm]);
      mt = fmaxf(mt, red[(kGroups + g) * kBM + tm]);
    }
    t_load[static_cast<size_t>(b) * M + m0 + tm] = mr * inv_R[b];
    t_rec[static_cast<size_t>(b) * M + m0 + tm] = mt * delta_over_K[b];
  }
}

}  // namespace

extern "C" int lp_terms_batch(const void* x, const void* p_rho,
                              const void* p_tau, const void* inv_R,
                              const void* delta_over_K, void* t_load,
                              void* t_rec, int B, int M, int P, void* stream) {
  const dim3 grid(B, (M + kBM - 1) / kBM);
  const size_t smem =
      (static_cast<size_t>(kBK) * kBM + 2 * static_cast<size_t>(kBK) * P +
       2 * kGroups * kBM) * sizeof(float);
  lp_terms_batch_kernel<<<grid, kBM * kGroups, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(p_rho),
      static_cast<const float*>(p_tau), static_cast<const float*>(inv_R),
      static_cast<const float*>(delta_over_K), static_cast<float*>(t_load),
      static_cast<float*>(t_rec), M, P);
  return static_cast<int>(cudaGetLastError());
}
