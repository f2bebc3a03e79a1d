// Chunkwise mLSTM forward with a carried state, in f32.
//
// Replaces the Pallas TPU kernel `mlstm_chunk_pallas`
// (src/repro/kernels/mlstm_chunk/kernel.py, body `_mlstm_kernel`).  q, k, v
// are (BH, S, Dh) in f32 or bf16, contiguous; log_f and log_i are (BH, S)
// f32; the initial state is S0 (BH, Dh, Dh) and n0 (BH, Dh) in f32, or null
// for zeros (what the Pallas kernel always starts from).  Per chunk of C
// rows (S a multiple of C), all in f32:
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
//
// What bounds it on an H100: prefill is operations (2 Dh flops per live
// (t, s) pair for q k^T and again for scores v, 4 C Dh^2 per chunk for
// inter and the state update, all f32); decode (S = C = 1) is bytes: the
// (Dh, Dh) state read and written, 1 MB per (b, h) at Dh = 512.
//
// The design.  The state does not fit a block's 227 KB of shared memory at
// Dh = 512, so its value columns are split: block (j, bh) owns
// S[:, j TV : (j + 1) TV] (TV = 64 columns, 128 KB in shared memory for the
// whole call) and writes those columns of h.  A column of h and of S needs
// only its own columns of v and S; the normalizer, F, A and the scores need
// q, k and the gates only, so every column block recomputes the scores of
// its chunk (Dh / TV = 8 times the q k^T work at Dh = 512; a first pass
// writing the scores once would move C^2 floats per chunk through device
// memory instead).  The chunk axis is a loop inside the block, the TPU
// grid's sequential axis.  Per tile of 16 rows: the rows of q staged in
// shared memory as f32, inter from the resident state slice, inter_n by
// warp reductions; then, over the key tiles of 16 rows at or below the
// tile's last row (tiles above the diagonal are skipped), the 16 x 16 score
// tile (one dot product of Dh per thread, 16-byte loads from rows padded to
// Dh + 4 floats so the reads hit distinct banks) and its product with the
// tile's columns of v, accumulated in registers.  Once every row of the
// chunk has read S_prev, the state slice and the normalizer are updated
// from the key tiles again.  Simple first: f32 FMAs on CUDA cores, no
// tensor cores, no TMA, no overlap of a tile's loads with the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

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

}  // namespace

// The shared memory one block needs at (Dh, C) (0 if Dh is not taken) and
// the most a block may take on the current device, for the wrapper's check.
extern "C" int mlstm_chunk_smem(int Dh, int C, long long* need, int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *need = block_smem_bytes(Dh, C);
  return static_cast<int>(cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

// dtype of q, k, v and h: 0 = f32, 1 = bf16.  s0 and n0 may be null (zero
// initial state).  S must be a multiple of C; Dh is 16, 32 or a multiple of
// 64 whose shared memory fits the device.
extern "C" int mlstm_chunk(const void* q, const void* k, const void* v,
                           const void* log_f, const void* log_i,
                           const void* s0, const void* n0, void* h,
                           void* s_out, void* n_out, int dtype, int BH, int S,
                           int Dh, int C, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || C <= 0 || S % C)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_tv<float>(q, k, v, log_f, log_i, s0, n0, h, s_out, n_out,
                              BH, S, Dh, C, s);
  if (dtype == 1)
    return dispatch_tv<__nv_bfloat16>(q, k, v, log_f, log_i, s0, n0, h, s_out,
                                      n_out, BH, S, Dh, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
