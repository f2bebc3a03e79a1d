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
// The rows of one (batch, kv head) are R = group * Sq, in the order (query
// head in group, position), so one key/value tile staged in shared memory
// serves every query head of its group.  Every route skips the key tiles
// wholly outside the causal/window band of its rows (`band`), as the Pallas
// `pl.when(live)` does.  The wrapper picks one of three routes per call
// (`kernels/flash_attention.py`, `plan`):
//
// * mma (bf16, R > 16): prefill and training.  Bound by bytes at the
//   serving and training shapes (about 60 flops a byte, under the card's
//   295), but only if the products run on tensor cores.  A block of 4 warps
//   owns 64 rows, 16 a warp.  Q (64 x D) and a double-buffered ring of K
//   and V tiles stay bf16 in shared memory, rows in 16-byte chunks XOR-
//   swizzled so `ldmatrix` reads 8 rows without bank conflicts; `cp.async`
//   stages tile t + 1 while tile t is multiplied.  S = Q K^T runs as bf16
//   `mma.sync.m16n8k16` with f32 accumulation (bf16 products are exact in
//   f32, so the logits differ from the twin's f32 einsum only by summation
//   order); the online softmax stays in f32 registers.  P V: the twin keeps
//   P in f32, and one bf16 rounding of P would cost 2^-9 of sum p|v|, past
//   the 1e-5 floor of the bf16 gate where the output nearly cancels; so P is
//   split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), two products with
//   the exact bf16 V, which keeps P to about 2^-17; the row sum l comes
//   from the f32 P.  Registers: the O accumulator is D / 2 f32 a thread
//   (128 at D = 256) and S is BK / 2, so Q is not held in registers but
//   `ldmatrix`-ed from shared memory each k-step, a k-step ahead of its
//   products; at D = 256 that fills the 255 registers a thread may have,
//   without spills (ptxas -v).  Shared memory: Q 64 x D plus 2 stages of K and V, BK rows
//   each (BK = 32 at D = 256, 64 below): 96 KB at D = 256, so two blocks
//   share an SM and the 152 blocks of gemma3's prefill are resident at once.
//   What holds it back in practice: most SMs then run one block, one warp a
//   scheduler, so a tile costs the latency of its instructions, and the
//   kernel lasts as long as its longest band (19 tiles at gemma3's
//   prefill).  So the per-tile instruction count is kept low: each row's
//   key band is computed once (a division each; an empty asm keeps the
//   compiler from recomputing it at every logit), tiles inside every row's
//   band of a warp skip the mask, tiles outside it skip the products, and
//   the ldmatrix addresses are a few per-lane registers plus compile-time
//   offsets.  The output is staged through the warp's rows of the Q tile
//   and written in 16-byte stores.
//
// * split (both dtypes, R <= 16): decode.  Bound by bytes (each live key
//   and value row read once); the tiled grid would run B * Hkv blocks, 4 on
//   132 SMs for gemma3.  The live band of each (batch, kv head) is cut into
//   n_split runs of split_len keys from split_begin, one block each, so the
//   blocks fill the card; a block reads its run once, in the input dtype,
//   and serves all its rows on CUDA cores (4 live rows do not fill an m16
//   tile): 32 threads a row for up to 4 rows (gemma3's group), else 8.  It
//   writes its partial (m, l, acc[D]) in f32 to the scratch the wrapper
//   allocates; a run with no live key for a row writes m = -1e30, l = 0.  A
//   second kernel merges the runs of each row in run order (no atomics), so
//   the same inputs give the same bits.
//
// * simt (f32, R > 16): f32 FMAs on CUDA cores, since tensor cores would
//   mean TF32 and break the f32 contract.
//   One block of 128 threads per (batch, kv head, tile of 16 rows); each
//   key/value tile of 32 rows is staged as f32 in shared memory with
//   16-byte loads; eight threads share a query row, each computing 4 of the
//   tile's 32 logits from shared memory (shared-memory bandwidth sets its
//   pace), the row's max and sum through warp shuffles, D / 8 output
//   columns in registers.  The split route runs this kernel on its runs.
//
// Kernels whose shared memory exceeds 48 KB raise their dynamic limit at
// the first launch, once per device and process.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;  // every route
constexpr int kBQ = 16;        // simt: query rows per block (8 threads a row)
constexpr int kBK = 32;        // simt: key/value rows per tile
constexpr int kMmaRows = 64;   // mma: query rows per block
constexpr int kNoKey = 1 << 30;  // mma: a row's first key when it has none
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 16;

enum Route { kSimt = 0, kMma = 1, kSplit = 2 };

struct Strides {
  long long b, h, s;  // elements between batches, heads, positions
};

// The split route's runs and scratch: run s covers keys
// [begin + s * len, begin + (s + 1) * len); partial p = ((b * Hkv + hk) *
// n + s) * R + row holds acc[p * D ...] and (m, l) at ml[2 p].
struct Splits {
  int n, begin, len;
  float* acc;
  float* ml;
};

// The band of key positions [lo, hi) that rows first..last of one (batch,
// kv head) can see.  Rows that straddle two query heads cover every
// position of the sequence.
__device__ inline void band(int first, int last, int Sq, int Skv, int causal,
                            int window, int q_offset, int& lo, int& hi) {
  int i_lo = first % Sq, i_hi = last % Sq;
  if (first / Sq != last / Sq) {
    i_lo = 0;
    i_hi = Sq - 1;
  }
  lo = 0;
  hi = Skv;
  if (causal) hi = min(hi, q_offset + i_hi + 1);
  if (window >= 0) lo = max(lo, q_offset + i_lo - window + 1);
}

__device__ inline bool visible(int qi, int kj, int causal, int window) {
  return (!causal || qi >= kj) && (window < 0 || qi - kj < window);
}

// ---------------------------------------------------------------- simt

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

template <int D, int TPR>
constexpr size_t simt_smem_bytes() {
  // Q tile, K tile with rows padded by 4 floats (no bank conflicts between
  // the 8 rows a quarter warp reads), V tile; all f32.
  return static_cast<size_t>(kThreads / TPR * D + kBK * (D + 4) + kBK * D) *
         sizeof(float);
}

// TPR threads share a query row, so a block holds 128 / TPR rows.  Split =
// false: block (tile of 16 rows, kv head, batch), TPR = 8, writes its rows
// of the output.  Split = true: block (run, kv head, batch) takes every row
// (R <= 128 / TPR) over its run of keys and writes unnormalized partials;
// TPR = 32 keeps all four warps busy on gemma3's 4 decode rows.
template <typename T, int D, bool Split, int kTPR>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int group, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, int window, int q_offset,
                       float scale, Splits sp) {
  constexpr int kRows = kThreads / kTPR;       // query rows per block
  constexpr int kLogits = kBK / kTPR;          // logits per thread per tile
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
  float* Qs = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* Ks = Qs + kRows * D;                   // [kBK][kKStride]
  float* Vs = Ks + kBK * kKStride;              // [kBK][D]

  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // this thread's query row in the block
  const int c = tid % kTPR;  // its lane among the row's threads
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int R = group * Sq;  // rows of (b, hk): (query head in group, position)
  const int row0 = Split ? 0 : blockIdx.x * kRows;
  const int rows = min(kRows, R - row0);

  int kv_begin, kv_end;
  band(row0, row0 + rows - 1, Sq, Skv, causal, window, q_offset, kv_begin,
       kv_end);
  if (Split) {
    const int run = sp.begin + blockIdx.x * sp.len;
    kv_begin = max(kv_begin, run);
    kv_end = min(kv_end, run + sp.len);
  }

  const T* kb = k + b * ks.b + static_cast<long long>(hk) * ks.h;
  const T* vb = v + b * vs.b + static_cast<long long>(hk) * vs.h;

  // Stage the query tile (rows past the end are zeros).
  for (int e = tid; e < kRows * kVecRow; e += kThreads) {
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

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    // Stage K and V: every load in flight before the first store; rows
    // past the band are zeros (masked below; zeros keep 0 * V finite).
    uint4 kbuf[kIters], vbuf[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads;
      const int kj = k0 + e / kVecRow;
      kbuf[it] = make_uint4(0, 0, 0, 0);
      vbuf[it] = make_uint4(0, 0, 0, 0);
      if (e < kTileVecs && kj < kv_end) {
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

    // Logits of keys k0 + c + kTPR * j for this row, as four partial sums
    // (one per lane of a float4), so the FMA chain is D / 4 long.
    float s[kLogits];
    {
      float4 part[kLogits];
#pragma unroll
      for (int j = 0; j < kLogits; ++j) part[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* qrow = Qs + r * D;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
        for (int j = 0; j < kLogits; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              Ks + (c + kTPR * j) * kKStride + d);
          part[j].x = fmaf(qv.x, kv.x, part[j].x);
          part[j].y = fmaf(qv.y, kv.y, part[j].y);
          part[j].z = fmaf(qv.z, kv.z, part[j].z);
          part[j].w = fmaf(qv.w, kv.w, part[j].w);
        }
      }
#pragma unroll
      for (int j = 0; j < kLogits; ++j)
        s[j] = (part[j].x + part[j].y) + (part[j].z + part[j].w);
    }
    bool live[kLogits];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kLogits; ++j) {
      const int kj = k0 + c + kTPR * j;
      live[j] = row_live && kj < kv_end && visible(qi, kj, causal, window);
      s[j] = live[j] ? s[j] * scale : kNegInf;
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
  if (Split) {
    const long long p =
        ((static_cast<long long>(b) * gridDim.y + hk) * sp.n + blockIdx.x) * R +
        my_row;
    if (c == 0) {
      sp.ml[2 * p] = m;
      sp.ml[2 * p + 1] = l;
    }
#pragma unroll
    for (int t = 0; t < kChunks; ++t)
      store<kW>(sp.acc + p * D + kW * (c + kTPR * t), acc + t * kW);
    return;
  }
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

// Merges the split route's runs: block (row, kv head, batch), one thread
// per output column, runs in order s = 0, 1, ...: M = max m_s, w_s =
// e^(m_s - M), out = sum w_s acc_s / max(sum w_s l_s, 1e-30).  Every load
// of a pass is independent of the sums, so a pass costs one round trip to
// memory.  A row no key is visible to has m_s = -1e30, l_s = 0 and acc_s = 0
// everywhere: zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_combine(T* __restrict__ o, int Sq, int group, int D,
                               Strides os, Splits sp) {
  const int row = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int R = gridDim.x;
  const long long p0 =
      (static_cast<long long>(b) * gridDim.y + hk) * sp.n * R + row;
  const float* ml = sp.ml + 2 * p0;
  float M = kNegInf;
#pragma unroll 16
  for (int s = 0; s < sp.n; ++s) M = fmaxf(M, ml[2 * s * R]);
  T* dst = o + b * os.b + static_cast<long long>(hk * group + row / Sq) * os.h +
           static_cast<long long>(row % Sq) * os.s;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float* acc = sp.acc + p0 * D + d;
    float L = 0.f, a = 0.f;
#pragma unroll 16
    for (int s = 0; s < sp.n; ++s) {
      const float w = expf(ml[2 * s * R] - M);
      L += w * ml[2 * s * R + 1];
      a += w * acc[static_cast<long long>(s) * R * D];
    }
    const float out = a / fmaxf(L, 1e-30f);
    if constexpr (sizeof(T) == 4) {
      dst[d] = out;
    } else {
      dst[d] = __float2bfloat16_rn(out);
    }
  }
}

// ---------------------------------------------------------------- mma

using bf16 = __nv_bfloat16;

// Keys per K/V tile of the mma route.
template <int D>
constexpr int kMmaBK = D == 256 ? 32 : 64;

template <int D>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kMmaRows + 4 * kMmaBK<D>) * D * sizeof(bf16);
}

// Element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled: the 8 rows one `ldmatrix` reads at one chunk
// index land in 8 distinct 16-byte bank groups.
template <int D>
__device__ inline int swz(int r, int c) {
  constexpr int kChunks = D / 8;                       // chunks per row
  constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  return r * D + ((c ^ ((r / kRowsPerLine) & kMask)) << 3);
}

// Block (tile of 64 rows, kv head, batch); warp w owns rows 16 w .. 16 w +
// 15 of the tile.  Fragment layouts are the PTX ISA's for m16n8k16: lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2 t, 2 t + 1
// of each 8-column tile of S and O.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel_mma(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           int Sq, int Skv, int group, Strides qs, Strides ks,
                           Strides vs, Strides os, int causal, int window,
                           int q_offset, float scale_log2) {
  constexpr int BK = kMmaBK<D>;
  constexpr int kRowChunks = D / 8;   // 16-byte chunks per row
  constexpr int kSTiles = BK / 8;     // 8-key tiles of S
  constexpr int kOTiles = D / 8;      // 8-column tiles of O
  static_assert(D % 16 == 0 && BK % 16 == 0, "unsupported D");

  extern __shared__ uint4 smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // [64][D]
  bf16* KVs = Qs + kMmaRows * D;                 // 2 x ([BK][D] K, [BK][D] V)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int R = group * Sq;
  const int row0 = blockIdx.x * kMmaRows;
  const int rows = min(kMmaRows, R - row0);

  int kv_begin, kv_end;
  band(row0, row0 + rows - 1, Sq, Skv, causal, window, q_offset, kv_begin,
       kv_end);

  const bf16* kb = k + b * ks.b + static_cast<long long>(hk) * ks.h;
  const bf16* vb = v + b * vs.b + static_cast<long long>(hk) * vs.h;

  // Stage Q (rows past the end are zeros).
  for (int e = tid; e < kMmaRows * kRowChunks; e += kThreads) {
    const int rr = e / kRowChunks, c = e % kRowChunks;
    const int row = row0 + rr;
    const bool ok = rr < rows;
    const bf16* src =
        ok ? q + b * qs.b + static_cast<long long>(hk * group + row / Sq) * qs.h +
                 static_cast<long long>(row % Sq) * qs.s + c * 8
           : q;
    cp_async16(Qs + swz<D>(rr, c), src, ok);
  }
  // A thread copies chunk c of rows r0, r0 + kRowStep, ... of each tile.
  constexpr int kRowStep = kThreads / kRowChunks;
  static_assert(kThreads % kRowChunks == 0 && BK % kRowStep == 0, "tile copy");
  const int c_own = tid % kRowChunks, r_own = tid / kRowChunks;
  auto stage_tile = [&](int stage, int k0) {
    bf16* Ks = KVs + stage * 2 * BK * D;
    bf16* Vs = Ks + BK * D;
    const bf16* kr = kb + static_cast<long long>(k0 + r_own) * ks.s + c_own * 8;
    const bf16* vr = vb + static_cast<long long>(k0 + r_own) * vs.s + c_own * 8;
#pragma unroll
    for (int i = 0; i < BK / kRowStep; ++i) {
      const int rr = r_own + i * kRowStep;
      const bool ok = k0 + rr < kv_end;
      cp_async16(Ks + swz<D>(rr, c_own), ok ? kr : kb, ok);
      cp_async16(Vs + swz<D>(rr, c_own), ok ? vr : vb, ok);
      kr += kRowStep * ks.s;
      vr += kRowStep * vs.s;
    }
  };
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;
  if (n_tiles > 0) stage_tile(0, kv_begin);
  cp_async_commit();

  // This lane's two rows (g and g + 8 of the warp's 16) and the keys
  // [lo, hi) each sees (none past the last row).  The empty asm keeps the
  // compiler from recomputing them, a division each, at every use.
  const int ra = 16 * warp + g, rb = ra + 8;
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = i == 0 ? ra : rb;
    const int qi = q_offset + (row0 + rr) % Sq;
    lo[i] = window >= 0 ? max(0, qi - window + 1) : 0;
    hi[i] = causal ? min(kv_end, qi + 1) : kv_end;
    if (rr >= rows) {
      lo[i] = kNoKey;
      hi[i] = 0;
    }
    asm volatile("" : "+r"(lo[i]), "+r"(hi[i]));
  }
  // Keys some row of the warp sees (tiles outside are skipped), and keys
  // every row sees (tiles inside need no mask).
  const int w_begin = __reduce_min_sync(0xffffffffu, min(lo[0], lo[1]));
  const int w_end = __reduce_max_sync(0xffffffffu, max(hi[0], hi[1]));
  const int full_lo = __reduce_max_sync(0xffffffffu, max(lo[0], lo[1]));
  const int full_hi = __reduce_min_sync(0xffffffffu, min(hi[0], hi[1]));

  // Each lane's ldmatrix byte addresses.  Swizzling changes only the low 3
  // bits of a chunk index, and steps of 16 rows keep its pattern, so an
  // operand needs kT = min(4, D / 16) addresses a lane; k-step kk adds the
  // compile-time 128 (kk / kT) bytes, and 16 rows 32 D bytes.
  constexpr int kT = D / 16 < 4 ? D / 16 : 4;
  const uint32_t q_base = smem_addr(Qs), kv_base = smem_addr(KVs);
  uint32_t q_at[kT], k_at[kT], v_at[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    q_at[j] = q_base + 2 * swz<D>(16 * warp + (lane & 15), 2 * j + (lane >> 4));
    k_at[j] = kv_base +
              2 * swz<D>((lane & 7) + ((lane >> 4) << 3), 2 * j + ((lane >> 3) & 1));
    v_at[j] = kv_base + 2 * BK * D +
              2 * swz<D>((lane & 7) + (((lane >> 3) & 1) << 3), 2 * j + (lane >> 4));
  }

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_begin + t * BK;
    if (t + 1 < n_tiles) stage_tile((t + 1) & 1, k0 + BK);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // Q and tile t have landed
    __syncthreads();
    if (k0 < w_end && k0 + BK > w_begin) {
      const uint32_t stage = (t & 1) * 4 * BK * D;  // bytes
      // S = Q K^T over D in k-steps of 16; the fragments of k-step kk + 1
      // are loaded before the products of kk, so shared-memory latency
      // overlaps the tensor cores.
      float s[kSTiles][4];
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      uint32_t qf[2][4], kf[2][kSTiles / 2][4];
      auto load_qk = [&](int kk, int buf) {
        ldsm_x4(qf[buf], q_at[kk % kT] + 128 * (kk / kT));
#pragma unroll
        for (int nn = 0; nn < kSTiles / 2; ++nn)
          ldsm_x4(kf[buf][nn], k_at[kk % kT] + stage + 128 * (kk / kT) + 32 * D * nn);
      };
      load_qk(0, 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if (kk + 1 < D / 16) load_qk(kk + 1, (kk + 1) & 1);
#pragma unroll
        for (int nn = 0; nn < kSTiles / 2; ++nn) {
          mma_bf16(s[2 * nn], qf[kk & 1], kf[kk & 1][nn][0], kf[kk & 1][nn][1]);
          mma_bf16(s[2 * nn + 1], qf[kk & 1], kf[kk & 1][nn][2], kf[kk & 1][nn][3]);
        }
      }
      // Mask (tiles that straddle a row's band), scale into log2 units,
      // and the rows' running max.
      float mx[2] = {kNegInf, kNegInf};
      if (k0 >= full_lo && k0 + BK <= full_hi) {
#pragma unroll
        for (int n = 0; n < kSTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= scale_log2;
            mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < kSTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * n + 2 * t4 + (e & 1);
            const bool ok = kj >= lo[e / 2] && kj < hi[e / 2];
            s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
            mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
          }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // A row with no visible key yet subtracts 0, so its -1e30 logits
        // give exactly 0.
        m_use[i] = m_new == kNegInf ? 0.f : m_new;
        alpha[i] = exp2f(m[i] - m_use[i]);
        m[i] = m_new;
      }
      float p_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - m_use[e / 2]);
          p_sum[e / 2] += s[n][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + p_sum[i];
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // O += P_hi V + P_lo V over the tile's keys in k-steps of 16: the S
      // fragments of key tiles 2 kk and 2 kk + 1 are the A fragment.  V's
      // fragments are loaded one step ahead, as above.
      constexpr int kVSteps = D / 16;
      uint32_t vf[2][4];
      auto load_v = [&](int i, int buf) {
        const int kk = i / kVSteps, dd = i % kVSteps;
        ldsm_x4_trans(vf[buf], v_at[dd % kT] + stage + 128 * (dd / kT) + 32 * D * kk);
      };
      load_v(0, 0);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_pair(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_pair(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dd = 0; dd < kVSteps; ++dd) {
          const int i = kk * kVSteps + dd;
          if (i + 1 < BK / 16 * kVSteps) load_v(i + 1, (i + 1) & 1);
          const uint32_t* bv = vf[i & 1];
          mma_bf16(acc[2 * dd], hi, bv[0], bv[1]);
          mma_bf16(acc[2 * dd + 1], hi, bv[2], bv[3]);
          mma_bf16(acc[2 * dd], lo, bv[0], bv[1]);
          mma_bf16(acc[2 * dd + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  // Normalize, stage this warp's rows in its rows of the Q tile, and write
  // them in 16-byte stores.
  cp_async_wait<0>();
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(Qs + swz<D>(ra, n) + col) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Qs + swz<D>(rb, n) + col) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * kRowChunks; e += 32) {
    const int rr = 16 * warp + e / kRowChunks, c = e % kRowChunks;
    if (rr >= rows) break;
    const int row = row0 + rr;
    bf16* dst = o + b * os.b +
                static_cast<long long>(hk * group + row / Sq) * os.h +
                static_cast<long long>(row % Sq) * os.s + c * 8;
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(Qs + swz<D>(rr, c));
  }
}

// ---------------------------------------------------------------- launch

// Raise a kernel's dynamic shared-memory limit once per device: the
// attribute persists in the context, so later launches skip the call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem,
                       std::atomic<bool>* raised) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev].store(true);
  return err;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Hq, Hkv, Sq, Skv;
  Strides qs, ks, vs, os;
  int causal, window, q_offset;
  float scale;
  Splits sp;
  cudaStream_t stream;
};

template <typename T, int D, bool Split, int TPR>
int launch_simt(const Args& a) {
  constexpr size_t smem = simt_smem_bytes<D, TPR>();
  auto kernel = flash_attention_kernel<T, D, Split, TPR>;
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = a.Hq / a.Hkv;
  const int x = Split ? a.sp.n : (group * a.Sq + kBQ - 1) / kBQ;  // TPR = 8
  kernel<<<dim3(x, a.Hkv, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Sq, a.Skv, group,
      a.qs, a.ks, a.vs, a.os, a.causal, a.window, a.q_offset, a.scale, a.sp);
  err = cudaGetLastError();
  if (err != cudaSuccess || !Split) return static_cast<int>(err);
  flash_attention_kernel_combine<T>
      <<<dim3(group * a.Sq, a.Hkv, a.B), kThreads, 0, a.stream>>>(
          static_cast<T*>(a.o), a.Sq, group, D, a.os, a.sp);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_attention_kernel_mma<D>;
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = a.Hq / a.Hkv;
  const dim3 grid((group * a.Sq + kMmaRows - 1) / kMmaRows, a.Hkv, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.Sq, a.Skv,
      group, a.qs, a.ks, a.vs, a.os, a.causal, a.window, a.q_offset,
      a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_route(int route, const Args& a) {
  if (route == kSplit) {
    const int rows = (a.Hq / a.Hkv) * a.Sq;
    if (rows > kBQ || a.sp.n < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (D >= 64) {
      if (rows <= kThreads / 32) return launch_simt<T, D, true, 32>(a);
    }
    return launch_simt<T, D, true, 8>(a);
  }
  if constexpr (sizeof(T) == 2) {
    if (route == kMma) return launch_mma<D>(a);
  } else {
    if (route == kSimt) return launch_simt<T, D, false, 8>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_d(int D, int route, const Args& a) {
  switch (D) {
    case 16: return launch_route<T, 16>(route, a);
    case 32: return launch_route<T, 32>(route, a);
    case 64: return launch_route<T, 64>(route, a);
    case 128: return launch_route<T, 128>(route, a);
    case 256: return launch_route<T, 256>(route, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Strides in elements, for q, k, v, o in turn:
// batch, head, position.  window < 0 means no window.  route: 0 = simt
// (f32 only), 1 = mma (bf16 only), 2 = split (group * Sq <= 16), with n_split runs of
// split_len keys from split_begin and f32 scratch of B * Hkv * n_split *
// group * Sq * (D + 2) values (unused by the other routes).
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, void* scratch,
    int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, int causal, int window, int q_offset, float scale,
    int route, int n_split, int split_begin, int split_len, void* stream) {
  const long long partials =
      static_cast<long long>(B) * Hkv * n_split * (Hq / Hkv) * Sq;
  float* acc = static_cast<float*>(scratch);
  const Args a{q, k, v, o, B, Hq, Hkv, Sq, Skv,
               Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
               Strides{vsb, vsh, vss}, Strides{osb, osh, oss},
               causal, window, q_offset, scale,
               Splits{n_split, split_begin, split_len, acc,
                      acc == nullptr ? nullptr : acc + partials * D},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>(D, route, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, route, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
