// Fused hard-max terms of the ordering LP, batched and single-instance.
//
// Replaces the Pallas TPU kernels `lp_terms_batch_pallas`
// (src/repro/kernels/lp_terms/kernel.py:101) and `lp_terms_pallas`
// (kernel.py:183).  For every ensemble member b (one instance for
// `lp_terms`) and coflow m:
//   t_load[b, m] = max_p (X^T P_rho)[b, m, p] * inv_R[b]
//   t_rec[b, m]  = max_p (X^T P_tau)[b, m, p] * delta_over_K[b]
// with x (B, M, M), p_rho / p_tau (B, M, P), all f32, any M, P >= 1.  The
// max runs over the P real ports only; the scale is applied after it
// (x -> x * s is monotone for s >= 0, so rounding keeps max and scale in
// either order).
//
// What bounds it on an H100.  Bytes (inputs once, outputs once) over
// 3.35 TB/s against FMAs over the f32 CUDA-core rate (67 TFLOP/s): the
// paper bucket (B = 32, M = 104, P = 24) is 33 MFLOP on 2.0 MB, bytes,
// 0.61 us; one paper instance (M = 100, P = 20) 0.8 MFLOP on 57 KB, bytes,
// 0.017 us; the whole trace (M = 526, P = 300) 332 MFLOP on 2.4 MB,
// operations, 5 us.  At the main path's shapes the real limits are the
// launch and the latency of one block's chain of loads, FMAs and barriers,
// so the design is about how many SMs work and how short each block's
// critical path is.
//
// Why CUDA cores in f32 and no tensor cores: a TF32 product keeps 10
// mantissa bits (about 2^-11 per product), 3xTF32 about 2^-21, both above
// rtol(1) = 4u = 2^-22 that the kernel is held to against its f32 twin;
// and the main path's 0.8 and 33 MFLOP are far below even the f32 rate.
//
// The previous design ran one block per (member, 32 rows), each thread one
// row and 16 port slots of a 128-port tile walked behind a predicate, and
// every (m, p) sum one serial chain of M FMAs: 4 blocks at (100, 20), 17 at
// (526, 300), 3 of 16 slots real at P = 20.  Now (`kernels/lp_terms.py:plan`
// picks the tiles on the host; the C entry refuses tiles it would not
// take and derives the shared memory from them, `lp_terms_smem` reports
// it):
//
// * Grid (member, m tile of BM rows, p tile of BP ports).  BP is P rounded
//   up to 4 (a thread's port width) while that is <= 64 (kWholePorts):
//   one block owns every port of its rows, and the row max and the scale
//   are fused into the epilogue, one launch, nothing to fill.  Above 64
//   ports p is split into tiles of 32; each block scales its tile's row
//   max and merges it into the output with an atomic max on the float's
//   bit pattern (signed max for >= 0, unsigned min for < 0: exact and
//   order-free), which the wrapper fills with -inf first.  BM is 32, 16
//   or 8 rows, as many as still give the SMs enough blocks.
// * The contraction is cut into chunks of 32 q.  A block holds KG groups
//   of threads (every chunk at once where there are at most 4, else 2);
//   in round r group g computes chunk r KG + g of every output of the
//   tile, as an in-order fmaf chain from 0; group 0 then adds the chunk
//   sums to its running sums in chunk order, reading the other groups'
//   sums from shared memory.  So every (m, p) sum is ((c_0 + c_1) + c_2)
//   + ... over chunks c_k = the fma chain of q in [32 k, 32 k + 32): its
//   association depends on M alone, not on B, P, the tiles or the SM
//   count, and `lp_terms` and a member of `lp_terms_batch` give the same
//   bits.  A summand passes through at most min(M, 32) + ceil(M / 32) - 1
//   <= M roundings, so with every summand >= 0 the sum is within (M - 1) u
//   of exact (u = 2^-24), as the old single chain was, and rtol(M) =
//   (2 M + 2) u still holds against the twin.
// * Each thread holds TM rows x 4 ports of both terms (TM = 2, or 1 where
//   the grid is too small to fill half the SMs: a shorter chain); one x
//   value feeds both products.  Operand rows reach shared memory by
//   cp.async: 16-byte copies where a piece of a row is aligned and whole,
//   4-byte ones (zero-filled out of range) at the ragged edge; p_rho and
//   p_tau share each piece's index.  Where the q extent is one round
//   (M <= 128: every main-path shape) it is staged once; past it, rounds
//   are double-buffered (the next round's copies fly during this round's
//   FMAs).  Past 48 KB of shared memory the kernel's limit is raised once
//   per device.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr int kChunk = 32;       // q per chunk: one in-order fmaf chain
constexpr int kTP = 4;           // ports per thread
constexpr int kMaxGroups = 4;    // chunk groups per block
constexpr int kMaxThreads = 512;
constexpr int kWholePorts = 64;  // one p tile up to this many ports
constexpr int kSplitPorts = 32;  // p tile width above it
constexpr int kMaxDevices = 16;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The q rows one stage holds: the whole extent when it is one round.
__host__ __device__ inline int stage_rows(int M, int KG) {
  return ceil_div(ceil_div(M, kChunk), KG) == 1 ? M : KG * kChunk;
}

__host__ __device__ inline int stage_count(int M, int KG) {
  return ceil_div(ceil_div(M, kChunk), KG) == 1 ? 1 : 2;
}

// Shared memory of one block, in floats: the stages (x rows of BM, p_rho
// and p_tau rows of BP), the other groups' chunk sums, the epilogue's
// per-column row maxima.
__host__ __device__ inline long long smem_floats(int M, int BM, int BP, int KG) {
  const long long stage = static_cast<long long>(stage_rows(M, KG)) * (BM + 2 * BP);
  return stage_count(M, KG) * stage + (KG - 1) * 2LL * BM * BP + 2LL * BM * (BP / kTP);
}

// 4 bytes global -> shared, asynchronously; zero where !pred (src is then
// not read).
__device__ inline void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// Four floats global -> shared, `left` of them real (zeros past them):
// one 16-byte copy where they are whole and aligned, else four 4-byte
// ones.  `base` is any readable address (a copy of 0 bytes reads none).
__device__ __forceinline__ void copy4(float* dst, const float* src, int left,
                                      const float* base) {
  if (left >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, true);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) cp_async4(dst + u, u < left ? src + u : base, u < left);
  }
}

// Issue the copies of q rows [q0, min(q0 + R, M)) into one stage: x
// columns [m0, m0 + BM), p_rho and p_tau columns [p0, p0 + BP).
__device__ void load_stage(float* st, const float* __restrict__ x,
                           const float* __restrict__ p_rho,
                           const float* __restrict__ p_tau, int M, int P,
                           int BM, int BP, int R, int m0, int p0, int q0) {
  float* xs = st;
  float* rs = xs + R * BM;
  float* ts = rs + R * BP;
  const int rows = min(R, M - q0);
  const int shift = BM == 32 ? 3 : BM == 16 ? 2 : 1;  // BM / 4 pieces a row
  for (int e = threadIdx.x; e < rows << shift; e += blockDim.x) {
    const int row = e >> shift, c = 4 * (e & ((1 << shift) - 1));
    const long long at = static_cast<long long>(q0 + row) * M + m0 + c;
    copy4(xs + row * BM + c, x + at, M - m0 - c, x);
  }
  // p_rho and p_tau share each piece (row, c), stepped by the block's
  // threads without a division per piece.
  const int pw = BP / 4;
  const int drow = blockDim.x / pw, dc = blockDim.x - drow * pw;
  int row = threadIdx.x / pw, c = threadIdx.x - row * pw;
  for (; row < rows; row += drow, c += dc) {
    if (c >= pw) c -= pw, ++row;
    if (row >= rows) break;
    const long long at = static_cast<long long>(q0 + row) * P + p0 + 4 * c;
    const int left = P - p0 - 4 * c;
    copy4(rs + row * BP + 4 * c, p_rho + at, left, p_rho);
    copy4(ts + row * BP + 4 * c, p_tau + at, left, p_tau);
  }
}

// One chunk of `depth` q rows: acc[i][j] = fmaf(x[q][i], p[q][j], acc[i][j])
// for q in order, both terms.
template <int TM>
__device__ __forceinline__ void chunk_fma(const float* xs, const float* rs, const float* ts,
                                          int BM, int BP, int depth,
                                          float (&ar)[TM][kTP], float (&at)[TM][kTP]) {
  auto step = [&](int k) {
    float xv[TM];
    if constexpr (TM == 2) {
      const float2 v = *reinterpret_cast<const float2*>(xs + k * BM);
      xv[0] = v.x, xv[1] = v.y;
    } else {
      xv[0] = xs[k * BM];
    }
    const float4 r = *reinterpret_cast<const float4*>(rs + k * BP);
    const float4 t = *reinterpret_cast<const float4*>(ts + k * BP);
    const float rv[kTP] = {r.x, r.y, r.z, r.w};
    const float tv[kTP] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < kTP; ++j) {
        ar[i][j] = fmaf(xv[i], rv[j], ar[i][j]);
        at[i][j] = fmaf(xv[i], tv[j], at[i][j]);
      }
    }
  };
  if (depth == kChunk) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) step(k);
  } else {
    for (int k = 0; k < depth; ++k) step(k);
  }
}

// Max merge of v into *out, exact and order-free for any sign: *out starts
// at -inf; a float >= 0 orders as its signed bits, one < 0 reversed as its
// unsigned bits.
__device__ inline void atomic_max_float(float* out, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(out), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(out), __float_as_uint(v));
  }
}

// One block's tile: rows [m0, m0 + BM), ports [p0, p0 + BP) of one member;
// x, p_rho, p_tau, t_load and t_rec already point at that member.
template <int TM>
__device__ __forceinline__ void lp_terms_tile(
    const float* __restrict__ x, const float* __restrict__ p_rho,
    const float* __restrict__ p_tau, float s_load, float s_rec,
    float* __restrict__ t_load, float* __restrict__ t_rec, int M, int P,
    int BM, int BP, int KG, int m0, int p0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int chunks = ceil_div(M, kChunk);
  const int rounds = ceil_div(chunks, KG);
  const int R = stage_rows(M, KG);
  const int stage = R * (BM + 2 * BP);
  float* part = smem + stage_count(M, KG) * stage;  // (KG - 1, 2, BM, BP)
  float* red = part + (KG - 1) * 2 * BM * BP;       // (2, BM, BP / kTP)

  const int cols = BP / kTP;
  const int per_group = BM / TM * cols;
  const int g = threadIdx.x / per_group;
  const int t = threadIdx.x - g * per_group;
  const int row0 = t / cols * TM, col0 = t % cols * kTP;
  const bool live = m0 + row0 < M && p0 + col0 < P;

  float tot_r[TM][kTP], tot_t[TM][kTP];  // group 0: sums of chunks so far
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTP; ++j) tot_r[i][j] = tot_t[i][j] = 0.0f;

  load_stage(smem, x, p_rho, p_tau, M, P, BM, BP, R, m0, p0, 0);
  cp_async_commit();
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds) {
      load_stage(smem + ((r + 1) & 1) * stage, x, p_rho, p_tau, M, P, BM, BP, R,
                 m0, p0, (r + 1) * KG * kChunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float acc_r[TM][kTP], acc_t[TM][kTP];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTP; ++j) acc_r[i][j] = acc_t[i][j] = 0.0f;
    const int c = r * KG + g;
    if (c < chunks && live) {
      const float* st = smem + (r & 1) * stage + g * kChunk * BM;
      const float* rs = smem + (r & 1) * stage + R * BM + g * kChunk * BP + col0;
      chunk_fma<TM>(st + row0, rs, rs + R * BP, BM, BP, min(kChunk, M - c * kChunk),
                    acc_r, acc_t);
    }
    if (g > 0) {
      float* dst = part + (g - 1) * 2 * BM * BP;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        *reinterpret_cast<float4*>(dst + (row0 + i) * BP + col0) =
            make_float4(acc_r[i][0], acc_r[i][1], acc_r[i][2], acc_r[i][3]);
        *reinterpret_cast<float4*>(dst + (BM + row0 + i) * BP + col0) =
            make_float4(acc_t[i][0], acc_t[i][1], acc_t[i][2], acc_t[i][3]);
      }
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTP; ++j) {
          tot_r[i][j] += acc_r[i][j];
          tot_t[i][j] += acc_t[i][j];
        }
      for (int h = 1; h < KG && r * KG + h < chunks; ++h) {
        const float* src = part + (h - 1) * 2 * BM * BP;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(src + (row0 + i) * BP + col0);
          const float4 b = *reinterpret_cast<const float4*>(src + (BM + row0 + i) * BP + col0);
          tot_r[i][0] += a.x, tot_r[i][1] += a.y, tot_r[i][2] += a.z, tot_r[i][3] += a.w;
          tot_t[i][0] += b.x, tot_t[i][1] += b.y, tot_t[i][2] += b.z, tot_t[i][3] += b.w;
        }
      }
    }
  }

  // Row max over the real ports: group 0 per thread column, then per row.
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float vr = -INFINITY, vt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTP; ++j) {
        if (p0 + col0 + j < P) {
          vr = fmaxf(vr, tot_r[i][j]);
          vt = fmaxf(vt, tot_t[i][j]);
        }
      }
      red[(row0 + i) * cols + col0 / kTP] = vr;
      red[(BM + row0 + i) * cols + col0 / kTP] = vt;
    }
  }
  __syncthreads();
  const bool split = P > BP;
  for (int e = threadIdx.x; e < 2 * BM; e += blockDim.x) {
    const int term = e / BM, m = m0 + e - term * BM;
    if (m >= M) continue;
    float v = -INFINITY;
    for (int k = 0; k < cols; ++k) v = fmaxf(v, red[e * cols + k]);
    v *= term ? s_rec : s_load;
    float* out = (term ? t_rec : t_load) + m;
    if (split) {
      atomic_max_float(out, v);
    } else {
      *out = v;
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kMaxThreads) lp_terms_batch_kernel(
    const float* __restrict__ x, const float* __restrict__ p_rho,
    const float* __restrict__ p_tau, const float* __restrict__ inv_R,
    const float* __restrict__ delta_over_K, float* __restrict__ t_load,
    float* __restrict__ t_rec, int M, int P, int BM, int BP, int KG) {
  const int b = blockIdx.x;
  const size_t xb = static_cast<size_t>(b) * M * M;
  const size_t pb = static_cast<size_t>(b) * M * P;
  const size_t tb = static_cast<size_t>(b) * M;
  lp_terms_tile<TM>(x + xb, p_rho + pb, p_tau + pb, inv_R[b], delta_over_K[b],
                    t_load + tb, t_rec + tb, M, P, BM, BP, KG, blockIdx.y * BM,
                    blockIdx.z * BP);
}

template <int TM>
__global__ void __launch_bounds__(kMaxThreads) lp_terms_kernel(
    const float* __restrict__ x, const float* __restrict__ p_rho,
    const float* __restrict__ p_tau, float inv_R, float delta_over_K,
    float* __restrict__ t_load, float* __restrict__ t_rec, int M, int P, int BM,
    int BP, int KG) {
  lp_terms_tile<TM>(x, p_rho, p_tau, inv_R, delta_over_K, t_load, t_rec, M, P, BM,
                    BP, KG, blockIdx.y * BM, blockIdx.z * BP);
}

// Check a plan's tiles against the shape; on success set the grid, the
// threads and the shared memory and, past 48 KB, raise the kernel's
// dynamic limit to the device's opt-in maximum, once per device (`limit`
// keeps that maximum; 0 where not yet asked).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, std::atomic<int>* limit, int B, int M, int P, int BM,
                    int BP, int TM, int KG, dim3* grid, int* threads, long long* smem) {
  const bool tiles_ok = (BM == 8 || BM == 16 || BM == 32) && BM % TM == 0 &&
                        BP > 0 && BP % kTP == 0 &&
                        (P > kWholePorts ? BP == kSplitPorts : BP >= P && BP <= kWholePorts) &&
                        KG >= 1 && KG <= kMaxGroups && KG <= ceil_div(M, kChunk);
  *threads = KG * (BM / TM) * (BP / kTP);
  if (!tiles_ok || *threads > kMaxThreads) return cudaErrorInvalidValue;
  *smem = 4 * smem_floats(M, BM, BP, KG);
  *grid = dim3(B, ceil_div(M, BM), ceil_div(P, BP));
  if (*smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int most = dev < kMaxDevices ? limit[dev].load() : 0;
  if (most == 0) {
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) limit[dev].store(most);
  }
  return *smem <= most ? cudaSuccess : cudaErrorInvalidValue;
}

template <int TM>
int launch_batch(const void* x, const void* p_rho, const void* p_tau, const void* inv_R,
                 const void* delta_over_K, void* t_load, void* t_rec, int B, int M, int P,
                 int BM, int BP, int KG, cudaStream_t stream) {
  static std::atomic<int> limit[kMaxDevices];
  dim3 grid;
  int threads = 0;
  long long smem = 0;
  cudaError_t err = prepare(lp_terms_batch_kernel<TM>, limit, B, M, P, BM, BP, TM, KG,
                            &grid, &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lp_terms_batch_kernel<TM><<<grid, threads, static_cast<size_t>(smem), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(p_rho),
      static_cast<const float*>(p_tau), static_cast<const float*>(inv_R),
      static_cast<const float*>(delta_over_K), static_cast<float*>(t_load),
      static_cast<float*>(t_rec), M, P, BM, BP, KG);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_single(const void* x, const void* p_rho, const void* p_tau, float inv_R,
                  float delta_over_K, void* t_load, void* t_rec, int M, int P, int BM,
                  int BP, int KG, cudaStream_t stream) {
  static std::atomic<int> limit[kMaxDevices];
  dim3 grid;
  int threads = 0;
  long long smem = 0;
  cudaError_t err = prepare(lp_terms_kernel<TM>, limit, 1, M, P, BM, BP, TM, KG, &grid,
                            &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lp_terms_kernel<TM><<<grid, threads, static_cast<size_t>(smem), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(p_rho),
      static_cast<const float*>(p_tau), inv_R, delta_over_K, static_cast<float*>(t_load),
      static_cast<float*>(t_rec), M, P, BM, BP, KG);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan's (BM, BP, TM, KG) come from `kernels/lp_terms.py:plan`; tiles
// the kernel cannot run are refused with cudaErrorInvalidValue.
extern "C" int lp_terms_batch(const void* x, const void* p_rho, const void* p_tau,
                              const void* inv_R, const void* delta_over_K, void* t_load,
                              void* t_rec, int B, int M, int P, int BM, int BP, int TM,
                              int KG, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (TM) {
    case 2: return launch_batch<2>(x, p_rho, p_tau, inv_R, delta_over_K, t_load, t_rec,
                                   B, M, P, BM, BP, KG, s);
    case 1: return launch_batch<1>(x, p_rho, p_tau, inv_R, delta_over_K, t_load, t_rec,
                                   B, M, P, BM, BP, KG, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int lp_terms(const void* x, const void* p_rho, const void* p_tau, float inv_R,
                        float delta_over_K, void* t_load, void* t_rec, int M, int P,
                        int BM, int BP, int TM, int KG, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (TM) {
    case 2: return launch_single<2>(x, p_rho, p_tau, inv_R, delta_over_K, t_load, t_rec,
                                    M, P, BM, BP, KG, s);
    case 1: return launch_single<1>(x, p_rho, p_tau, inv_R, delta_over_K, t_load, t_rec,
                                    M, P, BM, BP, KG, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory, in bytes, a block of the given tiles takes
// at M coflows (`Plan.smem` states the same count on the host).
extern "C" int lp_terms_smem(int M, int BM, int BP, int KG, long long* bytes) {
  if (M < 1 || BM < 1 || BP < kTP || KG < 1 || KG > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  *bytes = 4 * smem_floats(M, BM, BP, KG);
  return 0;
}
