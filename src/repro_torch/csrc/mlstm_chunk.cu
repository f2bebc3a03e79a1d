// Chunkwise mLSTM forward with a carried state.
//
// Replaces the Pallas TPU kernel `mlstm_chunk_pallas`
// (src/repro/kernels/mlstm_chunk/kernel.py:92, body `_mlstm_kernel` at
// :35).  q, k, v are (BH, S, Dh) in f32 or bf16, contiguous; log_f and
// log_i are (BH, S) f32; the initial state is S0 (BH, Dh, Dh) and n0 (BH,
// Dh) in f32, or null for zeros (what the Pallas kernel always starts
// from).  Per chunk of C rows (S a multiple of C), all in f32:
//
//   F      = cumsum(log_f)
//   inter  = e^F (q S_prev),  inter_n = e^F (q . n_prev)
//   A[t,s] = e^{F_t - F_s + log_i_s} for s <= t, else 0 (selected, never a
//            product with a 0/1 mask: masked exponents may be inf)
//   scores = (q k^T) o A
//   h      = (inter + scores v) / max(|inter_n + sum_s scores|, 1)
//   S      = e^{F_C} S_prev + (k w)^T v,  n = e^{F_C} n_prev + sum_s k w,
//            w = e^{F_C - F + log_i}
//
// h is written in q's dtype, the final S and n in f32 (fresh buffers: the
// normalizer is read whole by every block, so it is never updated in place).
// The wrapper picks one of three routes per call from the shape and dtype
// (`kernels/mlstm_chunk.py`, `plan`):
//
// * stream (C = 1: decode; f32 and bf16).  Bound by bytes: the (Dh, Dh) f32
//   state read once and written once (1 MB per (b, h) at Dh = 512).  Block
//   (column tile, bh) keeps 16 value columns of S in registers, 4 columns
//   of 8 rows a thread (256 threads, Dh / 16 x BH blocks: 512 at xLSTM's
//   decode, all resident at once), and issues its 8 16-byte loads of the
//   slice before any use, so 32 KB a block are in flight with no shared-
//   memory staging.  Per position: q S by warp shuffles and one exchange
//   through shared memory, q . n and q . k likewise, then S and n updated
//   in registers; after the last position the slice is written once.  All
//   arithmetic in f32, so it serves both dtypes.
//
// * mma (bf16, C >= 2, Dh a multiple of 64 up to 512: prefill).  Bound by
//   operations once they run on tensor cores: every product as bf16
//   `mma.sync.m16n8k16` with f32 accumulation, the products with an f32
//   operand (scores v, q S_prev, (k w)^T v) split hi + lo (P_hi = bf16(x),
//   P_lo = bf16(x - P_hi), about 2^-17 of x) into two bf16 products; q k^T
//   takes q and k as they are (exact in f32).  TF32's 10-bit mantissa would
//   break the 2e-4 contract.  The design is a two-pass split in the manner of
//   option (c), but the first pass carries the state, not the intra-chunk
//   part: the chunk recurrence runs alone, and everything that reads the
//   state is then parallel over chunks.  Not (a) narrower column blocks or
//   (b) a cluster sharing scores: both keep the simt route's chunk loop
//   inside a (b, h, column block) block, so the 512 x 512 state must stay
//   resident (a 64 KB f32 slice at 32 columns) next to q and k, and the row
//   tiles of a chunk wait on each other.  The two kernels:
//   - `mlstm_chunk_kernel_scan`, block (64 rows d, 64 columns e, bh), runs
//     the chunk loop over the state alone: its S tile lives in mma
//     accumulators (32 f32 a thread), A = (k w)^T by `ldmatrix.trans` from
//     k's [s][d] tile times w in registers, split hi + lo, B = v.  It writes
//     each chunk's starting state S_c, already split into hi and lo bf16
//     planes (the same 4 bytes as f32), and n_c to scratch, and the final
//     state in f32.  (Dh / 64)^2 BH blocks: 1024 at xLSTM's prefill.
//   - `mlstm_chunk_kernel_mma<TV>`, block (64 rows t, TV = 128 columns,
//     chunk, bh), then has no loop over chunks: flash attention with a
//     second product.  q's 64 rows stay in shared memory (64 KB at Dh =
//     512); a two-stage `cp.async` ring carries S_c's hi / lo rows, then per
//     key tile of 64 at or below the rows its k sub-tiles and its v tile.
//     It recomputes q k^T for each of the Dh / TV column blocks (4x at Dh =
//     512, about 6.5 GFLOP at xLSTM's prefill on tensor cores) rather than
//     hold 64 x 512 f32 of h a warp.  About 100 KB a block: two per SM.
//   Tiles are [rows][64] bf16 with 16-byte chunks XOR-swizzled by row, so
//   `ldmatrix` reads 8 rows without bank conflicts; a key or row past C is
//   zero-filled and masked.  Development runs (chip_smoke.py phase 2 on an
//   H100 80GB HBM3 at 700 W) at xLSTM's prefill, (16, 768, 512), C = 256:
//   307.5 us of device time (scan 102.8, output 204.8; ptxas: 96 and 200
//   registers, no spills) against 4025.8 us on the simt route; (a) and (b)
//   were not built.  What holds both back: 4 warps a block, and every warp
//   loads the same B fragments from shared memory (`wgmma` would share
//   them across the warpgroup).
//
// * simt (f32 with C > 1, and bf16 shapes the mma route does not take).
//   The first port's kernel, unchanged: f32 FMAs on CUDA cores.  The state does
//   not fit a block's 227 KB of shared memory at Dh = 512, so its value
//   columns are split: block (j, bh) owns S[:, j TV : (j + 1) TV] (TV = 64
//   columns, 128 KB in shared memory for the whole call) and writes those
//   columns of h.  Every column block recomputes the scores of its chunk.
//   The chunk axis is a loop inside the block, the TPU grid's sequential
//   axis.  Per tile of 16 rows: the rows of q staged in shared memory as
//   f32, inter from the resident state slice, inter_n by warp reductions;
//   then, over the key tiles of 16 rows at or below the tile's last row,
//   the 16 x 16 score tile (one dot product of Dh per thread, 16-byte loads
//   from rows padded to Dh + 4 floats) and its product with the tile's
//   columns of v, accumulated in registers.  Once every row of the chunk
//   has read S_prev, the state slice and the normalizer are updated from
//   the key tiles again.
//
// Kernels whose shared memory exceeds 48 KB raise their dynamic limit to
// the device's opt-in maximum at the first launch, once per device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "mma_sync.cuh"

namespace {

enum Route { kSimt = 0, kMma = 1, kStream = 2 };

// ---------------------------------------------------------------- simt

constexpr int kThreads = 256;
constexpr int kTR = 16;  // chunk rows per row tile
constexpr int kTK = 16;  // key rows per key tile
constexpr int kMaxDevices = 16;
static_assert(kTR * kTK == kThreads, "one score of the tile per thread");

// Four consecutive values of T, widened to f32.
__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline float4 load4(const __nv_bfloat16* p) {
  // Two 32-bit words of two bf16 each, the first in the low half; a bf16 is
  // the high half of the f32 with the same value.
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ inline void store1(float* p, float x) { *p = x; }

__device__ inline void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [0, kTR) of a tile: row r < rows is src[r * Dh + (0 .. Dh)], widened
// to f32, at dst[r * pitch]; rows past `rows` are zeros.
template <typename T>
__device__ inline void stage_rows(float* dst, const T* src, int rows, int Dh,
                                  int pitch) {
  const int groups = Dh / 4;
  for (int i = threadIdx.x; i < kTR * groups; i += kThreads) {
    const int r = i / groups, g = 4 * (i % groups);
    const float4 x = r < rows ? load4(src + static_cast<long long>(r) * Dh + g)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * pitch + g) = x;
  }
}

// The tile's TV columns of v: dst[r * TV + c] = src[r * Dh + c], zeros past
// `rows`.
template <typename T, int TV>
__device__ inline void stage_cols(float* dst, const T* src, int rows,
                                  int Dh) {
  constexpr int groups = TV / 4;
  for (int i = threadIdx.x; i < kTK * groups; i += kThreads) {
    const int r = i / groups, g = 4 * (i % groups);
    const float4 x = r < rows ? load4(src + static_cast<long long>(r) * Dh + g)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * TV + g) = x;
  }
}

__host__ __device__ constexpr long long smem_floats(int Dh, int TV, int C) {
  // State slice, normalizer, q rows, k rows, v columns, score tile,
  // inter_n, then the three gate vectors (F, log_i, w) of the chunk.
  return static_cast<long long>(Dh) * TV + Dh + 2LL * kTR * (Dh + 4) +
         static_cast<long long>(kTK) * TV + kTR * kTK + kTR + 3LL * C;
}

// Dynamic shared memory of one block at (Dh, C), with the column block
// `dispatch_tv` picks for Dh; 0 if Dh is not taken.
long long block_smem_bytes(int Dh, int C) {
  const int tv = (Dh == 16 || Dh == 32) ? Dh : (Dh % 64 == 0 ? 64 : 0);
  return tv ? 4 * smem_floats(Dh, tv, C) : 0;
}

template <typename T, int TV>
__global__ void __launch_bounds__(kThreads)
    mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ log_f,
                       const float* __restrict__ log_i,
                       const float* __restrict__ s0,
                       const float* __restrict__ n0, T* __restrict__ h,
                       float* __restrict__ s_out, float* __restrict__ n_out,
                       int S, int Dh, int C) {
  constexpr int kRowsPerPass = kThreads / TV;  // rows a pass of threads covers
  constexpr int kRPT = kTR / kRowsPerPass;     // tile rows per thread
  extern __shared__ float4 smem4[];
  const int pitch = Dh + 4;
  float* st = reinterpret_cast<float*>(smem4);  // (Dh, TV) state slice
  float* nv = st + Dh * TV;                     // (Dh,) normalizer
  float* qs = nv + Dh;                          // (kTR, pitch)
  float* ks = qs + kTR * pitch;                 // (kTK, pitch)
  float* vs = ks + kTK * pitch;                 // (kTK, TV)
  float* sc = vs + kTK * TV;                    // (kTR, kTK) score tile
  float* dn = sc + kTR * kTK;                   // (kTR,) q . n_prev
  float* Fg = dn + kTR;                         // (C,) cumulative log f
  float* Lg = Fg + C;                           // (C,) log i
  float* Wg = Lg + C;                           // (C,) state-update weights

  const int tid = threadIdx.x;
  const int e = tid % TV;  // this thread's column of the slice
  const int r0 = tid / TV;
  const int e0 = blockIdx.x * TV;
  const long long bh = blockIdx.y;
  const long long seq = bh * S;  // first position of this (b, h)
  const T* qb = q + seq * Dh;
  const T* kb = k + seq * Dh;
  const T* vb = v + seq * Dh;
  const long long sbase = bh * Dh * Dh + e0;

  for (int i = tid; i < Dh * TV / 4; i += kThreads) {
    const int d = i / (TV / 4), g = 4 * (i % (TV / 4));
    *reinterpret_cast<float4*>(st + d * TV + g) =
        s0 ? load4(s0 + sbase + static_cast<long long>(d) * Dh + g)
           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int d = tid; d < Dh; d += kThreads) nv[d] = n0 ? n0[bh * Dh + d] : 0.f;

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the previous chunk's readers of the gates are done
    for (int t = tid; t < C; t += kThreads) {
      Fg[t] = log_f[seq + c0 + t];
      Lg[t] = log_i[seq + c0 + t];
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += Fg[t];
        Fg[t] = acc;
      }
    }
    __syncthreads();
    const float f_tot = Fg[C - 1];
    for (int t = tid; t < C; t += kThreads)
      Wg[t] = expf(f_tot - Fg[t] + Lg[t]);

    for (int t0 = 0; t0 < C; t0 += kTR) {
      __syncthreads();  // qs and dn free
      stage_rows(qs, qb + static_cast<long long>(c0 + t0) * Dh,
                 min(kTR, C - t0), Dh, pitch);
      __syncthreads();
      float inter[kRPT], intra[kRPT], rsum[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) inter[i] = intra[i] = rsum[i] = 0.f;
      // q S_prev for this thread's rows, column e.
      for (int d = 0; d < Dh; d += 4) {
        const float a0 = st[d * TV + e], a1 = st[(d + 1) * TV + e];
        const float a2 = st[(d + 2) * TV + e], a3 = st[(d + 3) * TV + e];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const float4 x = load4(qs + (r0 + i * kRowsPerPass) * pitch + d);
          inter[i] += x.x * a0 + x.y * a1 + x.z * a2 + x.w * a3;
        }
      }
      // q . n_prev, one warp per row.
      {
        const int warp = tid / 32, lane = tid % 32;
        for (int r = warp; r < kTR; r += kThreads / 32) {
          float acc = 0.f;
          for (int d = lane; d < Dh; d += 32) acc += qs[r * pitch + d] * nv[d];
#pragma unroll
          for (int off = 16; off; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (lane == 0) dn[r] = acc;
        }
      }
      const int t_last = min(t0 + kTR, C) - 1;
      for (int k0 = 0; k0 <= t_last; k0 += kTK) {
        __syncthreads();  // ks, vs and sc free
        const int rows = min(kTK, C - k0);
        stage_rows(ks, kb + static_cast<long long>(c0 + k0) * Dh, rows, Dh,
                   pitch);
        stage_cols<T, TV>(vs, vb + static_cast<long long>(c0 + k0) * Dh + e0,
                          rows, Dh);
        __syncthreads();
        {
          const int tr = tid / kTK, ts = tid % kTK;
          const int t = t0 + tr, s = k0 + ts;
          float val = 0.f;
          if (t < C && s <= t) {
            const float* qr = qs + tr * pitch;
            const float* kr = ks + ts * pitch;
            float dot = 0.f;
            for (int d = 0; d < Dh; d += 4) {
              const float4 a = load4(qr + d), b = load4(kr + d);
              dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
            }
            val = dot * expf(Fg[t] - Fg[s] + Lg[s]);
          }
          sc[tr * kTK + ts] = val;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const float* row = sc + (r0 + i * kRowsPerPass) * kTK;
#pragma unroll
          for (int ts = 0; ts < kTK; ++ts) {
            intra[i] += row[ts] * vs[ts * TV + e];
            rsum[i] += row[ts];
          }
        }
      }
      T* hb = h + (seq + c0 + t0) * Dh + e0 + e;
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const int r = r0 + i * kRowsPerPass;
        if (t0 + r < C) {
          const float decay = expf(Fg[t0 + r]);
          const float num = decay * inter[i] + intra[i];
          const float den = decay * dn[r] + rsum[i];
          store1(hb + static_cast<long long>(r) * Dh,
                 num / fmaxf(fabsf(den), 1.f));
        }
      }
    }

    // Every row of the chunk has read S_prev: update the slice and n.
    const float decay = expf(f_tot);
    for (int k0 = 0; k0 < C; k0 += kTK) {
      __syncthreads();  // readers of st, nv, ks and vs are done
      const int rows = min(kTK, C - k0);
      stage_rows(ks, kb + static_cast<long long>(c0 + k0) * Dh, rows, Dh,
                 pitch);
      stage_cols<T, TV>(vs, vb + static_cast<long long>(c0 + k0) * Dh + e0,
                        rows, Dh);
      __syncthreads();
      float vr[kTK], wr[kTK];
#pragma unroll
      for (int ts = 0; ts < kTK; ++ts) {
        vr[ts] = vs[ts * TV + e];
        wr[ts] = ts < rows ? Wg[k0 + ts] : 0.f;
      }
      for (int d = r0; d < Dh; d += kRowsPerPass) {
        float acc = st[d * TV + e];
        if (k0 == 0) acc *= decay;
#pragma unroll
        for (int ts = 0; ts < kTK; ++ts) acc += (ks[ts * pitch + d] * wr[ts]) * vr[ts];
        st[d * TV + e] = acc;
      }
      for (int d = tid; d < Dh; d += kThreads) {
        float acc = nv[d];
        if (k0 == 0) acc *= decay;
#pragma unroll
        for (int ts = 0; ts < kTK; ++ts) acc += ks[ts * pitch + d] * wr[ts];
        nv[d] = acc;
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < Dh * TV / 4; i += kThreads) {
    const int d = i / (TV / 4), g = 4 * (i % (TV / 4));
    *reinterpret_cast<float4*>(s_out + sbase + static_cast<long long>(d) * Dh +
                               g) = load4(st + d * TV + g);
  }
  if (blockIdx.x == 0)
    for (int d = tid; d < Dh; d += kThreads) n_out[bh * Dh + d] = nv[d];
}

template <typename T, int TV>
int launch_mlstm(const void* q, const void* k, const void* v,
                 const void* log_f, const void* log_i, const void* s0,
                 const void* n0, void* h, void* s_out, void* n_out, int BH,
                 int S, int Dh, int C, cudaStream_t stream) {
  auto kernel = mlstm_chunk_kernel<T, TV>;
  const long long smem = block_smem_bytes(Dh, C);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    // Raise this instance's dynamic shared-memory limit to the device's
    // opt-in maximum once per device: the attribute persists in the context.
    static std::atomic<bool> raised[kMaxDevices];
    if (dev >= kMaxDevices || !raised[dev].load()) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) raised[dev].store(true);
    }
  }
  const dim3 grid(Dh / TV, BH);
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_f),
      static_cast<const float*>(log_i), static_cast<const float*>(s0),
      static_cast<const float*>(n0), static_cast<T*>(h),
      static_cast<float*>(s_out), static_cast<float*>(n_out), S, Dh, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_tv(const void* q, const void* k, const void* v,
                const void* log_f, const void* log_i, const void* s0,
                const void* n0, void* h, void* s_out, void* n_out, int BH,
                int S, int Dh, int C, cudaStream_t stream) {
  if (Dh == 16)
    return launch_mlstm<T, 16>(q, k, v, log_f, log_i, s0, n0, h, s_out, n_out,
                               BH, S, Dh, C, stream);
  if (Dh == 32)
    return launch_mlstm<T, 32>(q, k, v, log_f, log_i, s0, n0, h, s_out, n_out,
                               BH, S, Dh, C, stream);
  if (Dh % 64 == 0)
    return launch_mlstm<T, 64>(q, k, v, log_f, log_i, s0, n0, h, s_out, n_out,
                               BH, S, Dh, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------- stream

constexpr int kStreamThreads = 256;
constexpr int kStreamCols = 16;                      // value columns a block owns
constexpr int kStreamRowStep = kStreamThreads / 4;   // rows one pass covers
constexpr int kStreamPasses = 512 / kStreamRowStep;  // passes at the widest Dh
constexpr int kStreamWarps = kStreamThreads / 32;

__device__ inline float widen(float x) { return x; }
__device__ inline float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Block (column tile, bh) owns S[:, e0 : e0 + 16] of one (b, h), in
// registers: thread (r, c4) holds rows r + 64 j, columns e0 + c4 .. + 3.
// Each position is one chunk of C = 1.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
    mlstm_chunk_kernel_stream(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ log_f,
                              const float* __restrict__ log_i,
                              const float* __restrict__ s0,
                              const float* __restrict__ n0, T* __restrict__ h,
                              float* __restrict__ s_out,
                              float* __restrict__ n_out, int S, int Dh) {
  // Per warp: its sums of the 16 columns of q S, then q . n and q . k.
  __shared__ float red[kStreamWarps][kStreamCols + 2];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r = tid / 4, c4 = 4 * (tid % 4);
  const bool lead = tid % 4 == 0;  // the thread of its rows that holds n
  const int e0 = blockIdx.x * kStreamCols;
  const long long bh = blockIdx.y;
  const long long sbase = bh * Dh * Dh + e0 + c4;

  // Every load of the state slice is issued before any is used.
  float st[kStreamPasses][4], nr[kStreamPasses];
#pragma unroll
  for (int j = 0; j < kStreamPasses; ++j) {
    const int d = r + kStreamRowStep * j;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 && d < Dh)
      x = *reinterpret_cast<const float4*>(s0 + sbase +
                                           static_cast<long long>(d) * Dh);
    st[j][0] = x.x;
    st[j][1] = x.y;
    st[j][2] = x.z;
    st[j][3] = x.w;
    nr[j] = n0 && lead && d < Dh ? n0[bh * Dh + d] : 0.f;
  }

  for (int t = 0; t < S; ++t) {
    const long long pos = bh * S + t;
    const T* qt = q + pos * Dh;
    const T* kt = k + pos * Dh;
    float qd[kStreamPasses], kd[kStreamPasses], vv[4];
#pragma unroll
    for (int j = 0; j < kStreamPasses; ++j) {
      const int d = r + kStreamRowStep * j;
      qd[j] = d < Dh ? widen(qt[d]) : 0.f;
      kd[j] = d < Dh ? widen(kt[d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) vv[i] = widen(v[pos * Dh + e0 + c4 + i]);
    const float lf = log_f[pos], li = log_i[pos];

    // Partial sums over this thread's rows: q S (4 columns), q . n, q . k.
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kStreamPasses; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) part[i] += qd[j] * st[j][i];
      part[4] += qd[j] * nr[j];
      part[5] += lead ? qd[j] * kd[j] : 0.f;
    }
    // Over the warp's 8 rows (the lanes of one column group), then q . n
    // and q . k over the column groups too.
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 6; ++i)
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int i = 4; i < 6; ++i)
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
    if (lane < 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][4 * lane + i] = part[i];
    if (lane == 0) {
      red[warp][kStreamCols] = part[4];
      red[warp][kStreamCols + 1] = part[5];
    }

    // F = F_C = log_f, so e^{F_C - F + log_i} = e^{log_i}.
    const float decay = expf(lf), w = expf(li);
#pragma unroll
    for (int j = 0; j < kStreamPasses; ++j) {
      const float kw = kd[j] * w;
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = st[j][i] * decay + kw * vv[i];
      if (lead) nr[j] = nr[j] * decay + kw;
    }
    __syncthreads();
    if (tid < kStreamCols) {
      float inter = 0.f, qn = 0.f, qk = 0.f;
#pragma unroll
      for (int i = 0; i < kStreamWarps; ++i) {
        inter += red[i][tid];
        qn += red[i][kStreamCols];
        qk += red[i][kStreamCols + 1];
      }
      const float score = qk * w;  // (q . k) e^{F - F + log_i}
      const float num = decay * inter + score * widen(v[pos * Dh + e0 + tid]);
      store1(h + pos * Dh + e0 + tid, num / fmaxf(fabsf(decay * qn + score), 1.f));
    }
    __syncthreads();  // red is rewritten at the next position
  }

#pragma unroll
  for (int j = 0; j < kStreamPasses; ++j) {
    const int d = r + kStreamRowStep * j;
    if (d < Dh) {
      *reinterpret_cast<float4*>(s_out + sbase + static_cast<long long>(d) * Dh) =
          make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
      if (blockIdx.x == 0 && lead) n_out[bh * Dh + d] = nr[j];
    }
  }
}

// ---------------------------------------------------------------- mma

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;     // both kernels of the route: 4 warps
constexpr int kTileElems = 64 * 64;  // a staged [64][64] bf16 tile, 8 KB

__host__ __device__ constexpr int round64(int x) { return (x + 63) / 64 * 64; }

// Value columns of h per output block: 128 where Dh allows, else 64.
__host__ __device__ constexpr int mma_tv(int Dh) { return Dh % 128 == 0 ? 128 : 64; }

// Dynamic shared memory of the scan kernel: a ring of two (k, v) tile
// pairs, F and the update weights of one chunk, 4 floats of scan scratch.
__host__ __device__ constexpr long long scan_smem_bytes(int C) {
  return 4LL * kTileElems * 2 + 4LL * (2 * round64(C) + 4);
}

// Dynamic shared memory of the output kernel: q's 64 rows, a ring of two
// stages of 64 TV bf16, F and log_i of one chunk, n_c, 4 floats.
__host__ __device__ constexpr long long out_smem_bytes(int TV, int Dh, int C) {
  return 2LL * 64 * Dh + 2LL * 2 * 64 * TV + 4LL * (2 * round64(C) + Dh + 4);
}

// Element offset of 16-byte chunk c (0..7) of row r in a [rows][64] bf16
// tile whose chunks are XOR-swizzled by (r & 7): the 8 rows one `ldmatrix`
// reads at one chunk index land in 8 distinct 16-byte bank groups.  Rows
// 16 apart share the pattern, so a fragment's address steps 2048 bytes.
__device__ inline int swz(int r, int c) { return r * 64 + ((c ^ (r & 7)) << 3); }

// cp.async rows [0, tile_rows) x 64 columns of a bf16 matrix (row r at
// src + r * ld) into a swizzled tile; rows from `rows` on are zeros.
__device__ inline void stage_tile(bf16* tile, const bf16* src, long long ld,
                                  int tile_rows, int rows) {
  for (int i = threadIdx.x; i < tile_rows * 8; i += kMmaThreads) {
    const int r = i / 8, c = i % 8;
    const bool ok = r < rows;
    cp_async16(tile + swz(r, c), ok ? src + r * ld + c * 8 : src, ok);
  }
}

__device__ inline float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ inline float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// One chunk's gates: F[i] = log_f[0] + ... + log_f[i] (a block scan: warp
// shuffles, then the warps' totals from `red`) and L[i] = log_i[i] for
// i < C; zeros for C <= i < Cp.  Ends with a barrier.
__device__ void chunk_gates(const float* __restrict__ lf,
                            const float* __restrict__ li, int C, int Cp,
                            float* F, float* L, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float carry = 0.f;
  for (int base = 0; base < Cp; base += kMmaThreads) {
    const int i = base + threadIdx.x;
    float x = i < C ? lf[i] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) red[warp] = x;
    __syncthreads();
    float pre = carry;
    for (int w = 0; w < warp; ++w) pre += red[w];
    if (i < Cp) {
      F[i] = i < C ? pre + x : 0.f;
      L[i] = i < C ? li[i] : 0.f;
    }
    carry += red[0] + red[1] + red[2] + red[3];
    __syncthreads();
  }
}

// The state scan.  Block (d tile, e tile, bh) owns S[d0 : d0 + 64,
// e0 : e0 + 64] of one (b, h) in registers (warp w: rows d0 + 16 w ..
// + 15) across the chunk loop.  Before chunk c it writes S_c to
// planes[c] as hi and lo bf16 (and the e-tile-0 blocks n_c to ns[c]);
// after the last chunk, S and n to s_out and n_out in f32.  Per chunk:
// S = e^{F_C} S + (k w)^T v over key tiles of 64, with A = (k w)^T split
// hi + lo (k by `ldmatrix.trans` from its [s][d] tile, times w in f32) and
// B = v exact; n gets the same f32 products k w summed over s.
__global__ void __launch_bounds__(kMmaThreads)
    mlstm_chunk_kernel_scan(const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const float* __restrict__ log_f,
                            const float* __restrict__ log_i,
                            const float* __restrict__ s0,
                            const float* __restrict__ n0,
                            bf16* __restrict__ planes, float* __restrict__ ns,
                            float* __restrict__ s_out,
                            float* __restrict__ n_out, int S, int Dh, int C) {
  extern __shared__ uint4 smem_scan[];
  const int Cp = round64(C);
  bf16* ring = reinterpret_cast<bf16*>(smem_scan);  // 2 x (k tile, v tile)
  float* F = reinterpret_cast<float*>(ring + 4 * kTileElems);
  float* W = F + Cp;  // log i, then the update weights
  float* red = W + Cp;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tiles = Dh / 64;
  const int d0 = 64 * (blockIdx.x / tiles), e0 = 64 * (blockIdx.x % tiles);
  const bool writes_n = blockIdx.x % tiles == 0;
  const long long bh = blockIdx.y, BH = gridDim.y;
  const long long DD = static_cast<long long>(Dh) * Dh;
  const int NC = S / C;
  const int ra = d0 + 16 * warp + g;  // this lane's rows: ra and ra + 8

  // acc[n]: rows ra, ra + 8; columns e0 + 8 n + 2 t4, + 1.  n's quad sum
  // is kept in the t4 == 0 lane.
  float acc[8][4], nacc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = bh * DD + static_cast<long long>(ra + 8 * i) * Dh + e0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 x = s0 ? *reinterpret_cast<const float2*>(s0 + row + 8 * n + 2 * t4)
                          : make_float2(0.f, 0.f);
      acc[n][2 * i] = x.x;
      acc[n][2 * i + 1] = x.y;
    }
    nacc[i] = n0 && t4 == 0 ? n0[bh * Dh + ra + 8 * i] : 0.f;
  }
  auto emit = [&](int c) {
    bf16* hi = planes + (c * BH + bh) * 2 * DD;
    bf16* lo = hi + DD;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const long long at = static_cast<long long>(ra + 8 * i) * Dh + e0 + 8 * n + 2 * t4;
        uint32_t uh, ul;
        split_pair(acc[n][2 * i], acc[n][2 * i + 1], uh, ul);
        *reinterpret_cast<uint32_t*>(hi + at) = uh;
        *reinterpret_cast<uint32_t*>(lo + at) = ul;
      }
    if (writes_n && t4 == 0)
      for (int i = 0; i < 2; ++i) ns[(c * BH + bh) * Dh + ra + 8 * i] = nacc[i];
  };
  emit(0);

  // ldmatrix byte offsets in a [64][64] tile: A = k^T (.trans of k's rows
  // s, chunks of this warp's d rows), B = v (.trans, n-tile pair j).
  const uint32_t ring_at = smem_addr(ring);
  const uint32_t a_off =
      2 * swz((lane & 7) + ((lane >> 4) << 3), 2 * warp + ((lane >> 3) & 1));
  uint32_t b_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b_off[j] = 2 * swz((lane & 7) + (((lane >> 3) & 1) << 3), 2 * j + (lane >> 4));

  for (int c = 0; c < NC; ++c) {
    const long long row0 = bh * S + static_cast<long long>(c) * C;
    chunk_gates(log_f + row0, log_i + row0, C, Cp, F, W, red);
    const float f_tot = F[C - 1];
    for (int s = threadIdx.x; s < Cp; s += kMmaThreads)
      W[s] = s < C ? expf(f_tot - F[s] + W[s]) : 0.f;
    const float decay = expf(f_tot);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= decay;
    nacc[0] *= decay;
    nacc[1] *= decay;

    const int n_tiles = Cp / 64;
    auto issue = [&](int kt) {
      bf16* dst = ring + (kt & 1) * 2 * kTileElems;
      const long long at = (row0 + 64 * kt) * Dh;
      const int rows = min(64, C - 64 * kt);
      stage_tile(dst, k + at + d0, Dh, 64, rows);
      stage_tile(dst + kTileElems, v + at + e0, Dh, 64, rows);
    };
    issue(0);
    cp_async_commit();
    for (int kt = 0; kt < n_tiles; ++kt) {
      if (kt + 1 < n_tiles) issue(kt + 1);
      cp_async_commit();  // possibly empty: one group per iteration
      cp_async_wait<1>();
      __syncthreads();  // tile kt has landed (and, at kt = 0, W is written)
      const uint32_t base = ring_at + (kt & 1) * 4 * kTileElems;
      const float* wk = W + 64 * kt + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A's registers 0, 1 hold keys 2 t4, 2 t4 + 1 of the k-step (rows
        // ra, ra + 8); registers 2, 3 keys 2 t4 + 8, 2 t4 + 9.
        uint32_t a[4], hi[4], lo[4];
        ldsm_x4_trans(a, base + a_off + 2048 * kk);
        const float w[4] = {wk[16 * kk], wk[16 * kk + 1], wk[16 * kk + 8],
                            wk[16 * kk + 9]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x0 = bf16_lo(a[i]) * w[i / 2 * 2];
          const float x1 = bf16_hi(a[i]) * w[i / 2 * 2 + 1];
          nacc[i % 2] += x0 + x1;
          split_pair(x0, x1, hi[i], lo[i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[4];
          ldsm_x4_trans(b, base + 2 * kTileElems + b_off[j] + 2048 * kk);
          mma_bf16(acc[2 * j], hi, b[0], b[1]);
          mma_bf16(acc[2 * j + 1], hi, b[2], b[3]);
          mma_bf16(acc[2 * j], lo, b[0], b[1]);
          mma_bf16(acc[2 * j + 1], lo, b[2], b[3]);
        }
      }
      __syncthreads();  // the next issue refills this stage
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = nacc[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      nacc[i] = t4 == 0 ? x : 0.f;
    }
    if (c + 1 < NC) emit(c + 1);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* row = s_out + bh * DD + static_cast<long long>(ra + 8 * i) * Dh + e0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    if (writes_n && t4 == 0) n_out[bh * Dh + ra + 8 * i] = nacc[i];
  }
}

// The output.  Block (row tile of 64, column tile of TV, chunk c, bh);
// warp w owns chunk rows t0 + 16 w .. + 15, all TV columns.  q's 64 rows
// stay in shared memory; one ring of two stages carries, in turn, the
// Dh / 32 row blocks of S_c (hi and lo, [32][TV] each), then per key tile
// kt <= the row tile its Dh / 64 k sub-tiles and its v tile.  Phase 1:
// acc = q S_hi + q S_lo and q . n_c (from the q fragments), both scaled by
// e^{F_t}.  Phase 2, per key tile: scores = q k^T (exact bf16 products),
// then e^{F_t - F_s + log_i_s} selected where s <= t, row sums from the
// f32 scores, acc += P_hi v + P_lo v.  h = acc / max(|q . n + sum|, 1).
template <int TV>
__global__ void __launch_bounds__(kMmaThreads, 2)
    mlstm_chunk_kernel_mma(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ log_f,
                           const float* __restrict__ log_i,
                           const bf16* __restrict__ planes,
                           const float* __restrict__ ns, bf16* __restrict__ h,
                           int S, int Dh, int C) {
  constexpr int kNT = TV / 8;      // 8-column tiles of h
  constexpr int kStage = 64 * TV;  // elements of a ring stage
  extern __shared__ uint4 smem_mma[];
  const int nq = Dh / 64;
  const int Cp = round64(C);
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // nq x [64][64]
  bf16* ring = qs + nq * kTileElems;             // 2 x kStage
  float* F = reinterpret_cast<float*>(ring + 2 * kStage);
  float* L = F + Cp;
  float* nv = L + Cp;
  float* red = nv + Dh;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int col_tiles = Dh / TV;
  const int rt = blockIdx.x / col_tiles;
  const int t0 = 64 * rt, e0 = TV * (blockIdx.x % col_tiles);
  const int c = blockIdx.y;
  const long long bh = blockIdx.z, BH = gridDim.z;
  const long long DD = static_cast<long long>(Dh) * Dh;
  const long long row0 = bh * S + static_cast<long long>(c) * C;

  for (int j = 0; j < nq; ++j)
    stage_tile(qs + j * kTileElems, q + (row0 + t0) * Dh + 64 * j, Dh, 64,
               min(64, C - t0));
  cp_async_commit();
  chunk_gates(log_f + row0, log_i + row0, C, Cp, F, L, red);
  const float* nc = ns + (c * BH + bh) * Dh;
  for (int d = tid; d < Dh; d += kMmaThreads) nv[d] = nc[d];

  const bf16* p_hi = planes + (c * BH + bh) * 2 * DD + e0;
  const bf16* p_lo = p_hi + DD;
  const int n_b = Dh / 32;                // phase 1 steps
  const int n_a = (rt + 1) * (nq + 1);    // phase 2 steps
  auto issue = [&](int i) {
    bf16* dst = ring + (i & 1) * kStage;
    if (i < n_b) {
      const long long at = static_cast<long long>(32 * i) * Dh;
      for (int j = 0; j < TV / 64; ++j) {
        stage_tile(dst + j * 2048, p_hi + at + 64 * j, Dh, 32, 32);
        stage_tile(dst + 32 * TV + j * 2048, p_lo + at + 64 * j, Dh, 32, 32);
      }
      return;
    }
    const int kt = (i - n_b) / (nq + 1), j = (i - n_b) % (nq + 1);
    const long long at = (row0 + 64 * kt) * Dh;
    const int rows = min(64, C - 64 * kt);
    if (j < nq) {
      stage_tile(dst, k + at + 64 * j, Dh, 64, rows);
    } else {
      for (int jj = 0; jj < TV / 64; ++jj)
        stage_tile(dst + jj * kTileElems, v + at + e0 + 64 * jj, Dh, 64, rows);
    }
  };

  // ldmatrix byte offsets for k-step (chunk pair) j of a [rows][64] tile:
  // A = q (rows 16 w ..), B = k (rows: keys), B = S_c or v (.trans).
  const uint32_t q_at = smem_addr(qs), ring_at = smem_addr(ring);
  uint32_t q_off[4], k_off[4], b_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q_off[j] = 2 * swz(16 * warp + (lane & 15), 2 * j + (lane >> 4));
    k_off[j] = 2 * swz((lane & 7) + ((lane >> 4) << 3), 2 * j + ((lane >> 3) & 1));
    b_off[j] = 2 * swz((lane & 7) + (((lane >> 3) & 1) << 3), 2 * j + (lane >> 4));
  }

  // acc[n], s[n]: rows ta, tb = ta + 8; columns 8 n + 2 t4, + 1.
  const int ta = t0 + 16 * warp + g, tb = ta + 8;
  float acc[kNT][4], s[8][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  float qn[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f}, fa = 0.f, fb = 0.f;

  const int steps = n_b + n_a;
  issue(0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) issue(i + 1);
    cp_async_commit();  // possibly empty: one group per iteration
    cp_async_wait<1>();
    __syncthreads();  // step i (and q) have landed
    const uint32_t st = ring_at + (i & 1) * 2 * kStage;
    if (i < n_b) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int d = 32 * i + 16 * kk;
        uint32_t a[4];
        ldsm_x4(a, q_at + (d / 64) * 2 * kTileElems + q_off[(d % 64) / 16]);
        const float2 na = *reinterpret_cast<const float2*>(nv + d + 2 * t4);
        const float2 nb = *reinterpret_cast<const float2*>(nv + d + 8 + 2 * t4);
        qn[0] += bf16_lo(a[0]) * na.x + bf16_hi(a[0]) * na.y +
                 bf16_lo(a[2]) * nb.x + bf16_hi(a[2]) * nb.y;
        qn[1] += bf16_lo(a[1]) * na.x + bf16_hi(a[1]) * na.y +
                 bf16_lo(a[3]) * nb.x + bf16_hi(a[3]) * nb.y;
#pragma unroll
        for (int j = 0; j < TV / 16; ++j) {
          const uint32_t off = (j / 4) * 4096 + b_off[j % 4] + 2048 * kk;
          uint32_t bh_[4], bl_[4];
          ldsm_x4_trans(bh_, st + off);
          ldsm_x4_trans(bl_, st + 64 * TV + off);
          mma_bf16(acc[2 * j], a, bh_[0], bh_[1]);
          mma_bf16(acc[2 * j + 1], a, bh_[2], bh_[3]);
          mma_bf16(acc[2 * j], a, bl_[0], bl_[1]);
          mma_bf16(acc[2 * j + 1], a, bl_[2], bl_[3]);
        }
      }
      if (i == n_b - 1) {  // inter = e^F (q S_c), inter_n = e^F (q . n_c)
        fa = F[ta];
        fb = F[tb];
        const float ea = expf(fa), eb = expf(fb);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[n][0] *= ea;
          acc[n][1] *= ea;
          acc[n][2] *= eb;
          acc[n][3] *= eb;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 1);
          qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 2);
        }
        qn[0] *= ea;
        qn[1] *= eb;
      }
    } else {
      const int kt = (i - n_b) / (nq + 1), j = (i - n_b) % (nq + 1);
      if (j < nq) {  // scores += q[:, 64 j ..] k[64 kt .., 64 j ..]^T
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, q_at + j * 2 * kTileElems + q_off[kk]);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            uint32_t b[4];
            ldsm_x4(b, st + k_off[kk] + 2048 * nn);
            mma_bf16(s[2 * nn], a, b[0], b[1]);
            mma_bf16(s[2 * nn + 1], a, b[2], b[3]);
          }
        }
      } else {
        // Decay where s <= t, selected (a masked exponent may be inf).
        const int k0 = 64 * kt;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = e < 2 ? ta : tb, sk = k0 + 8 * n + 2 * t4 + (e & 1);
            const float ft = e < 2 ? fa : fb;
            s[n][e] = sk <= t ? s[n][e] * expf(ft - F[sk] + L[sk]) : 0.f;
            rsum[e / 2] += s[n][e];
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t hi[4], lo[4];
          split_pair(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
          split_pair(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
          split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
          split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
          for (int jv = 0; jv < TV / 16; ++jv) {
            uint32_t b[4];
            ldsm_x4_trans(b, st + (jv / 4) * 2 * kTileElems + b_off[jv % 4] + 2048 * kk);
            mma_bf16(acc[2 * jv], hi, b[0], b[1]);
            mma_bf16(acc[2 * jv + 1], hi, b[2], b[3]);
            mma_bf16(acc[2 * jv], lo, b[0], b[1]);
            mma_bf16(acc[2 * jv + 1], lo, b[2], b[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
    }
    __syncthreads();  // the next issue refills this stage
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
    den[r] = fmaxf(fabsf(qn[r] + rsum[r]), 1.f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r == 0 ? ta : tb;
    if (t >= C) continue;
    bf16* dst = h + (row0 + t) * Dh + e0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] / den[r], acc[n][2 * r + 1] / den[r]);
  }
}

// ---------------------------------------------------------------- launch

// Check `smem` bytes against the device's opt-in maximum and, past 48 KB,
// raise the kernel's dynamic limit to that maximum (and prefer the whole
// carveout as shared memory) once per device: the attributes persist in
// the context.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem, std::atomic<bool>* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024 || (dev < kMaxDevices && raised[dev].load())) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev].store(true);
  return err;
}

template <typename T>
int launch_stream(const void* q, const void* k, const void* v,
                  const void* log_f, const void* log_i, const void* s0,
                  const void* n0, void* h, void* s_out, void* n_out, int BH,
                  int S, int Dh, cudaStream_t stream) {
  mlstm_chunk_kernel_stream<T><<<dim3(Dh / kStreamCols, BH), kStreamThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_f),
      static_cast<const float*>(log_i), static_cast<const float*>(s0),
      static_cast<const float*>(n0), static_cast<T*>(h),
      static_cast<float*>(s_out), static_cast<float*>(n_out), S, Dh);
  return static_cast<int>(cudaGetLastError());
}

template <int TV>
int launch_out(const bf16* q, const bf16* k, const bf16* v,
               const float* log_f, const float* log_i, const bf16* planes,
               const float* ns, bf16* h, int BH, int S, int Dh, int C,
               cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  auto kernel = mlstm_chunk_kernel_mma<TV>;
  const long long smem = out_smem_bytes(TV, Dh, C);
  cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + 63) / 64 * (Dh / TV), S / C, BH);
  kernel<<<grid, kMmaThreads, static_cast<size_t>(smem), stream>>>(
      q, k, v, log_f, log_i, planes, ns, h, S, Dh, C);
  return static_cast<int>(cudaGetLastError());
}

// The scan, then the output kernel; scratch holds planes (NC, BH, 2, Dh,
// Dh) bf16, then ns (NC, BH, Dh) f32.
int launch_mma(const void* q, const void* k, const void* v, const void* log_f,
               const void* log_i, const void* s0, const void* n0, void* h,
               void* s_out, void* n_out, void* scratch, int BH, int S, int Dh,
               int C, cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  const long long NC = S / C;
  bf16* planes = static_cast<bf16*>(scratch);
  float* ns = reinterpret_cast<float*>(planes + NC * BH * 2 * Dh * Dh);
  const long long smem = scan_smem_bytes(C);
  cudaError_t err = allow_smem(mlstm_chunk_kernel_scan, smem, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_kernel_scan<<<dim3((Dh / 64) * (Dh / 64), BH), kMmaThreads,
                            static_cast<size_t>(smem), stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(log_f), static_cast<const float*>(log_i),
      static_cast<const float*>(s0), static_cast<const float*>(n0), planes,
      ns, static_cast<float*>(s_out), static_cast<float*>(n_out), S, Dh, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* lf = static_cast<const float*>(log_f);
  const auto* li = static_cast<const float*>(log_i);
  auto* hb = static_cast<bf16*>(h);
  if (mma_tv(Dh) == 128)
    return launch_out<128>(qb, kb, vb, lf, li, planes, ns, hb, BH, S, Dh, C, stream);
  return launch_out<64>(qb, kb, vb, lf, li, planes, ns, hb, BH, S, Dh, C, stream);
}

// Whether `route` takes (Dh, C), and its block's dynamic shared memory.
bool route_takes(int route, int dtype, int Dh, int C) {
  if (route == kStream) return C == 1 && Dh % kStreamCols == 0 && Dh <= 512;
  if (route == kMma) return dtype == 1 && C >= 2 && Dh % 64 == 0 && Dh <= 512;
  return route == kSimt && block_smem_bytes(Dh, C) > 0;
}

long long route_smem_bytes(int route, int Dh, int C) {
  if (route == kStream)
    return route_takes(kStream, 0, Dh, C)
               ? static_cast<long long>(sizeof(float)) * kStreamWarps * (kStreamCols + 2)
               : 0;
  if (route == kMma) {
    if (!route_takes(kMma, 1, Dh, C)) return 0;
    const long long scan = scan_smem_bytes(C), out = out_smem_bytes(mma_tv(Dh), Dh, C);
    return scan > out ? scan : out;
  }
  return route == kSimt ? block_smem_bytes(Dh, C) : 0;
}

}  // namespace

// The shared memory one block of `route` needs at (Dh, C) (0 if the route
// does not take them; the mma route's larger kernel) and the most a block
// may take on the current device, for the wrapper's check.
extern "C" int mlstm_chunk_smem(int route, int Dh, int C, long long* need,
                                int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *need = route_smem_bytes(route, Dh, C);
  return static_cast<int>(cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

// dtype of q, k, v and h: 0 = f32, 1 = bf16.  s0 and n0 may be null (zero
// initial state).  S must be a multiple of C.  route: 0 = simt (Dh 16, 32
// or a multiple of 64 whose shared memory fits), 1 = mma (bf16, C >= 2, Dh
// a multiple of 64 up to 512, S / C <= 65535 chunks; scratch of (S / C)
// BH Dh (4 Dh + 4) bytes), 2 = stream (C = 1, Dh a multiple of 16 up to
// 512).  scratch is unused by the simt and stream routes.
extern "C" int mlstm_chunk(const void* q, const void* k, const void* v,
                           const void* log_f, const void* log_i,
                           const void* s0, const void* n0, void* h,
                           void* s_out, void* n_out, void* scratch, int dtype,
                           int BH, int S, int Dh, int C, int route,
                           void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || C <= 0 || S % C ||
      (dtype != 0 && dtype != 1) || !route_takes(route, dtype, Dh, C))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kMma) {
    if (S / C > 65535 || scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(q, k, v, log_f, log_i, s0, n0, h, s_out, n_out, scratch,
                      BH, S, Dh, C, s);
  }
  if (route == kStream) {
    if (dtype == 0)
      return launch_stream<float>(q, k, v, log_f, log_i, s0, n0, h, s_out,
                                  n_out, BH, S, Dh, s);
    return launch_stream<__nv_bfloat16>(q, k, v, log_f, log_i, s0, n0, h,
                                        s_out, n_out, BH, S, Dh, s);
  }
  if (dtype == 0)
    return dispatch_tv<float>(q, k, v, log_f, log_i, s0, n0, h, s_out, n_out,
                              BH, S, Dh, C, s);
  return dispatch_tv<__nv_bfloat16>(q, k, v, log_f, log_i, s0, n0, h, s_out,
                                    n_out, BH, S, Dh, C, s);
}
