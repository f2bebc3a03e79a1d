// GQA flash attention, forward: online softmax in f32, causal and/or
// sliding-window masks, queries at absolute positions q_offset + i.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py).  q is (B, Hq, Sq, D), k and
// v are (B, Hkv, Skv, D), in f32 or bf16, with any strides over the first
// three axes and the last axis contiguous; the output has q's dtype.  Query
// head h reads key/value head h / (Hq / Hkv): no key or value is repeated.
// The masks are the reference's: kj < Skv; qi >= kj when causal;
// qi - kj < window when a window is given; qi = q_offset + i.  The running
// max starts at -1e30, so a fully masked row ends as zeros, never NaN.
//
// What bounds it on an H100: prefill is operations (4 D flops per live
// (query, key) pair), decode is bytes (each live key/value row read once
// for Sq = 1).  The design is the simple one: one block of 128 threads per
// (batch, kv head, tile of 16 query rows), where the rows of a block run
// over the group's query heads and positions together, so one key/value
// tile staged in shared memory serves every query head of its group.  The
// block walks the key/value tiles of 32 rows that hold a live pair of its
// band -- tiles wholly outside the causal/window band are never loaded, as
// the Pallas `pl.when(live)` skips them -- staging each tile as f32 in
// shared memory with 16-byte loads.  Eight threads share a query row: each
// computes 4 of the tile's 32 logits with f32 FMAs on CUDA cores, the row's
// max and sum go through warp shuffles, and each thread accumulates D / 8
// output columns in registers.  No tensor cores, no overlap of the next
// tile's loads with this tile's products: decode (Sq = 1) runs one block
// per (batch, kv head) and leaves most SMs idle.  At D = 256 the tiles take
// 80.5 KB of shared memory; the first launch on a device raises that
// kernel's dynamic limit, once per device and process.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kBQ = 16;               // query rows per block
constexpr int kBK = 32;               // key/value rows per tile
constexpr int kTPR = 8;               // threads per query row
constexpr int kThreads = kBQ * kTPR;  // 128
constexpr int kLogits = kBK / kTPR;   // logits per thread per tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 16;

// A 16-byte vector of T, widened to f32.
template <typename T>
__device__ inline void widen(const uint4& u, float* out);

template <>
__device__ inline void widen<float>(const uint4& u, float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

template <>
__device__ inline void widen<__nv_bfloat16>(const uint4& u, float* out) {
  // Each 32-bit word holds two bf16, the first in the low half; a bf16 is
  // the high half of the f32 with the same value.
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// W (2 or 4) f32 values rounded to T (nearest even), stored at dst.
template <int W>
__device__ inline void store(float* dst, const float* x) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  }
}

template <int W>
__device__ inline void store(__nv_bfloat16* dst, const float* x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  if constexpr (W == 4) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = lo;
  }
}

// W (2 or 4) consecutive f32 from shared memory.
template <int W>
__device__ inline void load(const float* src, float* x) {
  if constexpr (W == 4) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  } else {
    const float2 u = *reinterpret_cast<const float2*>(src);
    x[0] = u.x;
    x[1] = u.y;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // Q tile, K tile with rows padded by 4 floats (no bank conflicts between
  // the 8 rows a quarter warp reads), V tile; all f32.
  return static_cast<size_t>(kBQ * D + kBK * (D + 4) + kBK * D) * sizeof(float);
}

struct Strides {
  long long b, h, s;  // elements between batches, heads, positions
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int group, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, int window, int q_offset,
                       float scale) {
  constexpr int kE = 16 / sizeof(T);           // elements per 16-byte load
  constexpr int kVecRow = D / kE;              // 16-byte loads per row
  constexpr int kKStride = D + 4;              // padded K tile row
  // Each thread owns kChunks runs of kW output columns, the run t at
  // column kW * (c + kTPR * t): neighbouring threads, neighbouring columns.
  constexpr int kW = D >= 4 * kTPR ? 4 : 2;
  constexpr int kChunks = D / (kW * kTPR);
  constexpr int kCols = kW * kChunks;
  constexpr int kTileVecs = kBK * kVecRow;     // 16-byte loads per K tile
  constexpr int kIters = (kTileVecs + kThreads - 1) / kThreads;
  static_assert(D % (kW * kTPR) == 0 && D % kE == 0, "unsupported D");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][D]
  float* Ks = Qs + kBQ * D;                     // [kBK][kKStride]
  float* Vs = Ks + kBK * kKStride;              // [kBK][D]

  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // this thread's query row in the block
  const int c = tid % kTPR;  // its lane among the row's threads
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int R = group * Sq;  // rows of (b, hk): (query head in group, position)
  const int row0 = blockIdx.x * kBQ;
  const int rows = min(kBQ, R - row0);

  // The band of key positions any row of this block can see.  A block whose
  // rows straddle two query heads covers every position of the sequence.
  const int last = row0 + rows - 1;
  int i_lo = row0 % Sq, i_hi = last % Sq;
  if (row0 / Sq != last / Sq) {
    i_lo = 0;
    i_hi = Sq - 1;
  }
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_offset + i_hi + 1);
  if (window >= 0) kv_begin = max(kv_begin, q_offset + i_lo - window + 1);

  const T* kb = k + b * ks.b + static_cast<long long>(hk) * ks.h;
  const T* vb = v + b * vs.b + static_cast<long long>(hk) * vs.h;

  // Stage the query tile (rows past the end are zeros).
  for (int e = tid; e < kBQ * kVecRow; e += kThreads) {
    const int rr = e / kVecRow, cv = e % kVecRow;
    float f[kE] = {};
    if (rr < rows) {
      const int row = row0 + rr;
      const T* src = q + b * qs.b +
                     static_cast<long long>(hk * group + row / Sq) * qs.h +
                     static_cast<long long>(row % Sq) * qs.s + cv * kE;
      widen<T>(__ldg(reinterpret_cast<const uint4*>(src)), f);
    }
#pragma unroll
    for (int j = 0; j < kE; j += 4)
      *reinterpret_cast<float4*>(Qs + rr * D + cv * kE + j) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }

  const int my_row = row0 + r;
  const bool row_live = r < rows;
  const int qi = q_offset + my_row % Sq;
  // A warp holds 32 / kTPR rows; it computes if any of them is live.
  const bool warp_live = (r & ~(32 / kTPR - 1)) < rows;
  const int lane0 = (tid & 31) & ~(kTPR - 1);  // first lane of this row

  float m = kNegInf, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) acc[t] = 0.f;

  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    // Stage K and V: every load in flight before the first store; rows
    // past Skv are zeros (masked below; zeros keep 0 * V finite).
    uint4 kbuf[kIters], vbuf[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads;
      const int kj = k0 + e / kVecRow;
      kbuf[it] = make_uint4(0, 0, 0, 0);
      vbuf[it] = make_uint4(0, 0, 0, 0);
      if (e < kTileVecs && kj < Skv) {
        const int off = (e % kVecRow) * kE;
        kbuf[it] = __ldg(reinterpret_cast<const uint4*>(
            kb + static_cast<long long>(kj) * ks.s + off));
        vbuf[it] = __ldg(reinterpret_cast<const uint4*>(
            vb + static_cast<long long>(kj) * vs.s + off));
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads;
      if (e < kTileVecs) {
        const int rr = e / kVecRow, off = (e % kVecRow) * kE;
        float fk[kE], fv[kE];
        widen<T>(kbuf[it], fk);
        widen<T>(vbuf[it], fv);
#pragma unroll
        for (int j = 0; j < kE; j += 4) {
          *reinterpret_cast<float4*>(Ks + rr * kKStride + off + j) =
              make_float4(fk[j], fk[j + 1], fk[j + 2], fk[j + 3]);
          *reinterpret_cast<float4*>(Vs + rr * D + off + j) =
              make_float4(fv[j], fv[j + 1], fv[j + 2], fv[j + 3]);
        }
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    // Logits of keys k0 + c + kTPR * j for this row.
    float s[kLogits];
#pragma unroll
    for (int j = 0; j < kLogits; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < kLogits; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + (c + kTPR * j) * kKStride + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    bool live[kLogits];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kLogits; ++j) {
      const int kj = k0 + c + kTPR * j;
      bool ok = row_live && kj < Skv;
      if (causal) ok = ok && qi >= kj;
      if (window >= 0) ok = ok && qi - kj < window;
      live[j] = ok;
      s[j] = ok ? s[j] * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
#pragma unroll
    for (int w = kTPR / 2; w > 0; w /= 2)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, w));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // finite: both >= -1e30
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kLogits; ++j) {
      s[j] = live[j] ? expf(s[j] - m_new) : 0.f;
      p_sum += s[j];
    }
#pragma unroll
    for (int w = kTPR / 2; w > 0; w /= 2)
      p_sum += __shfl_xor_sync(0xffffffffu, p_sum, w);
    l = l * alpha + p_sum;
    m = m_new;
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[t] *= alpha;
    // acc += P V: key kk's probability lives in lane kk % kTPR of the row.
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float p =
          __shfl_sync(0xffffffffu, s[kk / kTPR], lane0 | (kk % kTPR));
      const float* vrow = Vs + kk * D;
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        float vv[kW];
        load<kW>(vrow + kW * (c + kTPR * t), vv);
#pragma unroll
        for (int w = 0; w < kW; ++w)
          acc[t * kW + w] = fmaf(p, vv[w], acc[t * kW + w]);
      }
    }
  }

  if (!row_live) return;
  const float den = fmaxf(l, 1e-30f);
  T* dst = o + b * os.b +
           static_cast<long long>(hk * group + my_row / Sq) * os.h +
           static_cast<long long>(my_row % Sq) * os.s;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    float out[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) out[w] = acc[t * kW + w] / den;
    store<kW>(dst + kW * (c + kTPR * t), out);
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, const long long* st,
                 int causal, int window, int q_offset, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    // Raise this kernel's dynamic shared-memory limit once per device: the
    // attribute persists in the context, so later launches skip the call.
    static std::atomic<bool> raised[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || !raised[dev].load()) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) raised[dev].store(true);
    }
  }
  const int group = Hq / Hkv;
  const dim3 grid((group * Sq + kBQ - 1) / kBQ, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, group,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Hq, int Hkv, int Sq, int Skv, const long long* st,
               int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
#define REPRO_FLASH_CASE(DIM)                                               \
  case DIM:                                                                 \
    return launch_flash<T, DIM>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, causal, \
                                window, q_offset, scale, stream);
  switch (D) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Strides in elements, for q, k, v, o in turn:
// batch, head, position.  window < 0 means no window.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int causal, int window, int q_offset, float scale, void* stream) {
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, st, causal,
                             window, q_offset, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, st,
                                     causal, window, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
