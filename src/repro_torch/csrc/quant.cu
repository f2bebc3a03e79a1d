// Per-row int8 quantize (stochastic rounding) and dequantize.
//
// Replace the Pallas TPU kernels `quantize_pallas` and `dequantize_pallas`
// (src/repro/kernels/quant/kernel.py, bodies `_quant_kernel` and
// `_dequant_kernel`).  For x, noise (R, C) f32, per row r:
//   scale[r] = max(max_c |x[r, c]| / 127, 1e-30)
//   q[r, c]  = clip(floor(x[r, c] / scale[r] + noise[r, c]), -127, 127)  (int8)
// and dequantize writes out[r, c] = float(q[r, c]) * scale[r].
//
// Bit-parity with the reference is the contract, so every step rounds as
// IEEE f32 does on the host: both divisions are `__fdiv_rn` (no reciprocal,
// no `__fdividef`), the noise is added with `__fadd_rn` (never contracted
// into an FMA), the product of dequantize is `__fmul_rn`, and the library
// is built without `--use_fast_math`, so subnormal x and scales are kept
// (no flush to zero).  The row maximum is exact in any order.  NaN inputs
// are not taken: `fmaxf` drops a NaN where `jnp.max` propagates it.
//
// What bounds them on an H100: bytes.  Quantize reads 8 bytes per element
// (x and noise) and writes 1, plus 4 per row; dequantize reads 1 and
// writes 4, plus 4 per row.  The gradient exchange of gemma3-1b (about
// 1e9 elements) moves about 9.0 GB through quantize (2.69 ms at
// 3.35 TB/s) and 5.0 GB through each dequantize (1.49 ms).
//
// Design: one warp per row (8 rows per block of 256 threads), so the row
// maximum is a warp shuffle and needs no shared memory or second launch.
// Where C is a multiple of 4 and the rows are aligned (the trainer's rows
// of 512: 4 float4 loads of x and of noise per lane) the loads are 16
// bytes a lane and the int8 stores 4 bytes a lane; other widths take the
// scalar loop.  The row is read twice (the maximum, then the
// quantization); the second pass finds it in L1/L2, so device memory sees
// it about once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ signed char quant_one(float x, float scale, float noise) {
  float q = floorf(__fadd_rn(__fdiv_rn(x, scale), noise));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ noise,
                                signed char* __restrict__ q,
                                float* __restrict__ scale, int rows, int cols,
                                bool vec) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * cols;

  float amax = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    for (int c = lane; c < cols / 4; c += 32) {
      const float4 v = x4[c];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int c = lane; c < cols; c += 32) amax = fmaxf(amax, fabsf(x[base + c]));
  }
  amax = warp_max(amax);
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-30f);
  if (lane == 0) scale[row] = s;

  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const float4* n4 = reinterpret_cast<const float4*>(noise + base);
    char4* q4 = reinterpret_cast<char4*>(q + base);
    for (int c = lane; c < cols / 4; c += 32) {
      const float4 v = x4[c];
      const float4 n = n4[c];
      q4[c] = make_char4(quant_one(v.x, s, n.x), quant_one(v.y, s, n.y),
                         quant_one(v.z, s, n.z), quant_one(v.w, s, n.w));
    }
  } else {
    for (int c = lane; c < cols; c += 32)
      q[base + c] = quant_one(x[base + c], s, noise[base + c]);
  }
}

__global__ void dequantize_kernel(const signed char* __restrict__ q,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, int rows, int cols,
                                  bool vec) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * cols;
  const float s = scale[row];
  if (vec) {
    const char4* q4 = reinterpret_cast<const char4*>(q + base);
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int c = lane; c < cols / 4; c += 32) {
      const char4 v = q4[c];
      o4[c] = make_float4(__fmul_rn(static_cast<float>(v.x), s),
                          __fmul_rn(static_cast<float>(v.y), s),
                          __fmul_rn(static_cast<float>(v.z), s),
                          __fmul_rn(static_cast<float>(v.w), s));
    }
  } else {
    for (int c = lane; c < cols; c += 32)
      out[base + c] = __fmul_rn(static_cast<float>(q[base + c]), s);
  }
}

int blocks_for(int rows) { return (rows + kWarpsPerBlock - 1) / kWarpsPerBlock; }

// Vector loads and stores need C a multiple of 4 and aligned row starts:
// 16 bytes for the f32 operands, 4 for the int8 one.
bool vectorizable(int cols, const void* f0, const void* f1, const void* i8) {
  const uintptr_t f = reinterpret_cast<uintptr_t>(f0) | reinterpret_cast<uintptr_t>(f1);
  return (cols & 3) == 0 && f % 16 == 0 && reinterpret_cast<uintptr_t>(i8) % 4 == 0;
}

}  // namespace

extern "C" int quantize(const void* x, const void* noise, void* q, void* scale,
                        int rows, int cols, void* stream) {
  quantize_kernel<<<blocks_for(rows), 32 * kWarpsPerBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<signed char*>(q), static_cast<float*>(scale), rows, cols,
      vectorizable(cols, x, noise, q));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize(const void* q, const void* scale, void* out, int rows,
                          int cols, void* stream) {
  dequantize_kernel<<<blocks_for(rows), 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), rows, cols, vectorizable(cols, out, out, q));
  return static_cast<int>(cudaGetLastError());
}
