// Flow-space resolution round of the batched circuit calendar.
//
// Replaces the Pallas TPU kernel `event_resolve_pallas`
// (src/repro/kernels/event_resolve/kernel.py:89, body
// `_event_resolve_kernel` at :58).  For each member g of the (instance,
// core) batch, at its instant t[g], over its F flows in priority order:
//
//   waiting = pending && rel <= t
//   idle    = waiting && free_in[src] <= t && free_out[dst] <= t
//   claim   = reserving ? waiting : idle
//   start   = idle && the flow is the first claimer on both its ports
//
// The kernel writes the (G, F) start mask, each port's first claimer
// (G, N) int32 (F where none claims; the calendar's free-time update reads
// them), and per member whether some idle flow did not start (the greedy
// calendar's test for another round at the same instant).  Times are f64,
// compared natively: the TPU kernel compared in f32, which would break the
// calendar's bit-identical establish and complete times.
//
// What bounds it on an H100: bytes.  A round reads about 18 bytes per flow
// (two int32 ports, an f64 release, the pending byte; the start byte
// written) and 24 per port and member; it does a handful of compares per
// flow.  The TPU kernel found first claimers with a strictly-lower-
// triangular (F, F) x (F, N) product, O(F^2 N) work (7.1e10 entries at the
// whole trace's 266,260 flows).  Here the first claimer of a port is the
// minimum claiming flow id, an `atomicMin` on int32 in shared memory over
// the member's 2N port slots: O(F), exact, and independent of the order in
// which threads arrive, so the result is the same on every run.
//
// The design: one block per member; each warp takes 32 consecutive flows
// at a time, so loads coalesce.  Pass 1 reads each flow's pending byte and
// release once, and its ports and their free times only if it waits; it
// records the idle bit of each flow in shared memory (one 32-bit word per
// warp step, from a ballot) and claims its ports.  Pass 2 re-reads the
// ports only of idle flows (from L2) and writes every start byte.  Shared
// memory holds 2N + ceil(F/32) words: 34.5 KB at the trace's F = 266,260
// and N = 152.  Above the default 48 KB of dynamic shared memory the first
// launch on a device raises the kernel's limit to the device's opt-in
// maximum (227 KB on Hopper, about 1.8 million flows).

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 16;

__device__ __forceinline__ int clamp_port(int p, int n) {
  // Ports of waiting flows lie in [0, n) by contract; the clamp only keeps
  // a malformed input inside the block's shared memory.
  return min(max(p, 0), n - 1);
}

__global__ void event_resolve_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const double* __restrict__ rel, const double* __restrict__ free_in,
    const double* __restrict__ free_out, const bool* __restrict__ pending,
    const double* __restrict__ t, bool* __restrict__ start,
    int* __restrict__ first_in, int* __restrict__ first_out,
    bool* __restrict__ blocked, int f, int n, int reserving) {
  extern __shared__ int smem[];
  int* fin = smem;       // (n,) first claimer per ingress port
  int* fout = smem + n;  // (n,) first claimer per egress port
  unsigned* idle_bits = reinterpret_cast<unsigned*>(smem + 2 * n);
  const size_t fbase = static_cast<size_t>(blockIdx.x) * f;
  const size_t nbase = static_cast<size_t>(blockIdx.x) * n;
  const double tg = t[blockIdx.x];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int words = (f + 31) >> 5;

  for (int p = threadIdx.x; p < 2 * n; p += blockDim.x) smem[p] = f;
  __syncthreads();

  // Pass 1: idle bits and claims.  `w` is the same on all lanes of a warp,
  // so every lane reaches the ballot.
  for (int w = warp; w < words; w += warps) {
    const int i = (w << 5) + lane;
    bool waiting = false;
    bool idle = false;
    int s = 0;
    int d = 0;
    if (i < f) {
      waiting = pending[fbase + i] && rel[fbase + i] <= tg;
      if (waiting) {
        s = clamp_port(src[fbase + i], n);
        d = clamp_port(dst[fbase + i], n);
        idle = free_in[nbase + s] <= tg && free_out[nbase + d] <= tg;
      }
    }
    const unsigned bits = __ballot_sync(kFullMask, idle);
    if (lane == 0) idle_bits[w] = bits;
    if (reserving ? waiting : idle) {
      atomicMin(&fin[s], i);
      atomicMin(&fout[d], i);
    }
  }
  __syncthreads();

  // Pass 2: an idle flow starts iff it is the first claimer on both ports.
  int stuck = 0;
  for (int w = warp; w < words; w += warps) {
    const int i = (w << 5) + lane;
    if (i >= f) continue;
    bool go = false;
    if ((idle_bits[w] >> lane) & 1u) {
      const int s = clamp_port(src[fbase + i], n);
      const int d = clamp_port(dst[fbase + i], n);
      go = fin[s] == i && fout[d] == i;
      stuck |= !go;
    }
    start[fbase + i] = go;
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    first_in[nbase + p] = fin[p];
    first_out[nbase + p] = fout[p];
  }
  stuck = __syncthreads_or(stuck);
  if (threadIdx.x == 0) blocked[blockIdx.x] = stuck != 0;
}

}  // namespace

extern "C" int event_resolve(const void* src, const void* dst, const void* rel,
                             const void* free_in, const void* free_out,
                             const void* pending, const void* t, void* start,
                             void* first_in, void* first_out, void* blocked,
                             int members, int flows, int ports, int reserving,
                             void* stream) {
  const int words = (flows + 31) / 32;
  const int threads = std::min(1024, std::max(32, words * 32));
  const size_t smem = static_cast<size_t>(2 * ports + words) * sizeof(int);
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
          event_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) raised[dev].store(true);
    }
  }
  event_resolve_kernel<<<members, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const double*>(rel), static_cast<const double*>(free_in),
      static_cast<const double*>(free_out), static_cast<const bool*>(pending),
      static_cast<const double*>(t), static_cast<bool*>(start),
      static_cast<int*>(first_in), static_cast<int*>(first_out),
      static_cast<bool*>(blocked), flows, ports, reserving);
  return static_cast<int>(cudaGetLastError());
}
