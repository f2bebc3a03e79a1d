// Fused hard-max terms of the ordering LP, batched and single-instance.
//
// Replaces the Pallas TPU kernels `lp_terms_batch_pallas` and
// `lp_terms_pallas` (src/repro/kernels/lp_terms/kernel.py).  For every
// ensemble member b (one instance for `lp_terms`) and coflow m:
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
// is a few microseconds and launch latency dominates.  One instance of the
// trace scale (M = 526, P = 300) is 332 MFLOP on 2.4 MB: operations bound
// it (5 us), and its 17 row tiles fill 17 of the 132 SMs.
//
// The design is one launch per call: grid (member, 32-row tile of m), each
// block walking the port axis in tiles of at most 128 (a running row max
// carried across tiles, so any P works) and, inside a port tile, the q
// axis in 32-deep tiles staged in shared memory (x tile, P_rho and P_tau
// tiles); f32 FMAs on CUDA cores (no TF32, no library), the row max and
// the scale fused into the epilogue, so the (M, P) products never reach
// device memory.  Every (m, p) sum runs over q in order whatever the port
// tiling, so a wider P changes no bit of the narrower ports' sums.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 32;       // output rows (m) per block
constexpr int kBK = 32;       // contraction depth (q) per tile
constexpr int kGroups = 8;    // port groups: 256 threads = kBM x kGroups
constexpr int kMaxPPerThread = 16;
constexpr int kPT = kGroups * kMaxPPerThread;  // port tile width, 128

// One block's rows [m0, m0 + kBM) of one member; x, p_rho, p_tau, t_load
// and t_rec already point at that member.
__device__ __forceinline__ void lp_terms_rows(
    const float* __restrict__ x, const float* __restrict__ p_rho,
    const float* __restrict__ p_tau, float s_load, float s_rec,
    float* __restrict__ t_load, float* __restrict__ t_rec, int M, int P,
    int m0) {
  extern __shared__ float smem[];
  const int pt = min(P, kPT);
  float* xs = smem;               // (kBK, kBM)
  float* rs = xs + kBK * kBM;     // (kBK, pt)
  float* ts = rs + kBK * pt;      // (kBK, pt)
  float* red = ts + kBK * pt;     // (2, kGroups, kBM) epilogue maxima

  const int tm = threadIdx.x % kBM;
  const int tp = threadIdx.x / kBM;

  float mr = -INFINITY, mt = -INFINITY;
  for (int p0 = 0; p0 < P; p0 += kPT) {
    const int pw = min(kPT, P - p0);
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
        xs[e] = (q < M && m < M) ? x[static_cast<size_t>(q) * M + m] : 0.0f;
      }
      for (int e = threadIdx.x; e < kBK * pw; e += blockDim.x) {
        const int kk = e / pw, p = e % pw;
        const int q = q0 + kk;
        const bool in = q < M;
        const size_t at = static_cast<size_t>(q) * P + p0 + p;
        rs[e] = in ? p_rho[at] : 0.0f;
        ts[e] = in ? p_tau[at] : 0.0f;
      }
      __syncthreads();
      const int depth = min(kBK, M - q0);
      for (int kk = 0; kk < depth; ++kk) {
        const float xv = xs[kk * kBM + tm];
#pragma unroll
        for (int u = 0; u < kMaxPPerThread; ++u) {
          const int p = tp + kGroups * u;
          if (p < pw) {
            acc_r[u] = fmaf(xv, rs[kk * pw + p], acc_r[u]);
            acc_t[u] = fmaf(xv, ts[kk * pw + p], acc_t[u]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int u = 0; u < kMaxPPerThread; ++u) {
      if (tp + kGroups * u < pw) {
        mr = fmaxf(mr, acc_r[u]);
        mt = fmaxf(mt, acc_t[u]);
      }
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
    t_load[m0 + tm] = mr * s_load;
    t_rec[m0 + tm] = mt * s_rec;
  }
}

__global__ void lp_terms_batch_kernel(
    const float* __restrict__ x, const float* __restrict__ p_rho,
    const float* __restrict__ p_tau, const float* __restrict__ inv_R,
    const float* __restrict__ delta_over_K, float* __restrict__ t_load,
    float* __restrict__ t_rec, int M, int P) {
  const int b = blockIdx.x;
  const size_t xb = static_cast<size_t>(b) * M * M;
  const size_t pb = static_cast<size_t>(b) * M * P;
  const size_t tb = static_cast<size_t>(b) * M;
  lp_terms_rows(x + xb, p_rho + pb, p_tau + pb, inv_R[b], delta_over_K[b],
                t_load + tb, t_rec + tb, M, P, blockIdx.y * kBM);
}

__global__ void lp_terms_kernel(
    const float* __restrict__ x, const float* __restrict__ p_rho,
    const float* __restrict__ p_tau, float inv_R, float delta_over_K,
    float* __restrict__ t_load, float* __restrict__ t_rec, int M, int P) {
  lp_terms_rows(x, p_rho, p_tau, inv_R, delta_over_K, t_load, t_rec, M, P,
                blockIdx.x * kBM);
}

size_t smem_bytes(int P) {
  const size_t pt = static_cast<size_t>(P < kPT ? P : kPT);
  return (static_cast<size_t>(kBK) * kBM + 2 * kBK * pt +
          2 * kGroups * kBM) * sizeof(float);
}

}  // namespace

extern "C" int lp_terms_batch(const void* x, const void* p_rho,
                              const void* p_tau, const void* inv_R,
                              const void* delta_over_K, void* t_load,
                              void* t_rec, int B, int M, int P, void* stream) {
  const dim3 grid(B, (M + kBM - 1) / kBM);
  lp_terms_batch_kernel<<<grid, kBM * kGroups, smem_bytes(P),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(p_rho),
      static_cast<const float*>(p_tau), static_cast<const float*>(inv_R),
      static_cast<const float*>(delta_over_K), static_cast<float*>(t_load),
      static_cast<float*>(t_rec), M, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lp_terms(const void* x, const void* p_rho, const void* p_tau,
                        float inv_R, float delta_over_K, void* t_load,
                        void* t_rec, int M, int P, void* stream) {
  lp_terms_kernel<<<(M + kBM - 1) / kBM, kBM * kGroups, smem_bytes(P),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(p_rho),
      static_cast<const float*>(p_tau), inv_R, delta_over_K,
      static_cast<float*>(t_load), static_cast<float*>(t_rec), M, P);
  return static_cast<int>(cudaGetLastError());
}
